#!/usr/bin/env python3
"""Time the tensor-core dq kernel (`csrc/flash_bwd_dq_sm90.cu`) at two
depths of its K/V ring, on one CUDA card:

    python3 tools/dq_ring_depth.py

The library is built from the sources as they are (ring depth N); a
copy of the dq source with depth 5 - N (2 <-> 3) is built beside it. At
the Llama training shape (B=2, T=2048, H=32, K=8, d=128, causal) and at
BERT-base's (B=32, T=128, H=K=12, d=64, full, key padding) both run on
the same bf16 inputs: their outputs must be equal bit for bit (the
depth changes no arithmetic), then each is timed with a cold L2
(`chip_smoke.cold_ms`) in turns N, M, M, N, N, M. Prints the card's name
and power limit and one line a shape.
"""
import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.kernels import _build  # noqa: E402
from mxnet_tpu_torch.kernels import flash_attention as fa  # noqa: E402


def build_other_depth(tmp: Path):
    """(depth of the source, depth of the copy, the copy's dq entry)."""
    src = (_build.CSRC / "flash_bwd_dq_sm90.cu").read_text()
    pat = r"constexpr int STAGES = (\d+);"
    n = int(re.search(pat, src).group(1))
    m = 5 - n
    cu = tmp / "dq_other.cu"
    cu.write_text(re.sub(pat, f"constexpr int STAGES = {m};", src))
    nvcc = _build._nvcc()
    objs = []
    for f in (cu, _build.CSRC / "status.cu"):
        obj = tmp / (f.stem + ".o")
        subprocess.run([nvcc, *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
                        "-c", str(f), "-o", str(obj)], check=True,
                       capture_output=True)
        objs.append(str(obj))
    lib = tmp / "libdq_other.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                    *objs], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mxtt_flash_bwd_dq_tc
    fn.argtypes, fn.restype = fa._DQ.argtypes, ctypes.c_int
    return n, m, fn


def main() -> int:
    if not torch.cuda.is_available():
        print("dq_ring_depth: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load_library()
    with tempfile.TemporaryDirectory() as tmp:
        n, m, other = build_other_depth(Path(tmp))

        def run_other(q, k, v, dout, lse, delta, causal, scale, lengths):
            dq = torch.empty_like(q)
            with torch.cuda.device(q.device):
                rc = other(dq.data_ptr(), *fa._backward_args(
                    q, k, v, dout, lse, delta, lengths), int(causal),
                    float(scale), _build.dtype_code(q),
                    _build.stream_handle(q.device))
            if rc:
                raise RuntimeError(f"depth-{m} dq failed to launch ({rc})")
            return dq

        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        bert_lens = np.random.RandomState(cs.SEED + 13).randint(
            cs.BERT_T // 2, cs.BERT_T + 1, cs.BERT_B).tolist()
        for label, B, T, H, K, d, lens, causal in (
                ("train", cs.TRAIN_B, cs.TRAIN_T, 32, 8, 128,
                 [cs.TRAIN_T] * cs.TRAIN_B, True),
                ("bert", cs.BERT_B, cs.BERT_T, 12, 12, 64, bert_lens,
                 False)):
            q, dout = (torch.randn(B, T, H, d, generator=gen, device="cuda")
                       .bfloat16() for _ in range(2))
            k, v = (torch.randn(B, T, K, d, generator=gen, device="cuda")
                    .bfloat16() for _ in range(2))
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            scale = 1.0 / math.sqrt(d)
            out, lse = fa.flash_attention_forward(q, k, v, causal, scale,
                                                  lengths, return_lse=True)
            delta = fa.attention_delta(out, dout)
            args = (q, k, v, dout, lse, delta, causal, scale, lengths)
            runs = {n: lambda: fa.flash_bwd_dq(*args),
                    m: lambda: run_other(*args)}
            same = torch.equal(runs[n](), runs[m]())
            if not same:
                print(f"dq_ring_depth: {label}: depths {n} and {m} differ",
                      file=sys.stderr)
                return 1
            times = [(depth, cs.cold_ms(torch, runs[depth], flush))
                     for depth in (n, m, m, n, n, m)]
            med = {depth: float(np.median([t for dd, t in times
                                           if dd == depth]))
                   for depth in (n, m)}
            print(f"[dq ring depth] {label} B={B} T={T} H={H} K={K} d={d}: "
                  f"equal bit for bit; ms in turns "
                  + ", ".join(f"{dd} stages {t:.4f}" for dd, t in times)
                  + f"; median {n} stages {med[n]:.4f}, {m} stages "
                  f"{med[m]:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
