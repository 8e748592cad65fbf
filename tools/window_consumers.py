#!/usr/bin/env python3
"""Time the tensor-core window kernel (`csrc/window_attention_sm90.cu`)
with one and with two consumer warpgroups a block, on one CUDA card:

    python3 tools/window_consumers.py

The library is built from the sources as they are (N consumers, 64
folded rows each); a copy of the window source with 3 - N consumers
(2 <-> 1) is built beside it, so one block holds 128 or 64 rows and the
grid twice or half the blocks. At the spec serve phase's chunk shape
(B=1, W=256, H=32, K=8, d=128, bs=16, valid lengths 257-512) and verify
shape (B=8, W=5, 131-505 cached tokens) both run on the same bf16
inputs: their outputs must be equal bit for bit (each row's arithmetic
is the same), then each is timed with a cold L2 (`chip_smoke.cold_ms`)
in turns N, M, M, N, N, M. Prints the card's name and power limit and
one line a shape.
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
from mxnet_tpu_torch.kernels import flash_decode as fd  # noqa: E402


def build_other(tmp: Path):
    """(consumers of the source, of the copy, the copy's entry point)."""
    src = (_build.CSRC / "window_attention_sm90.cu").read_text()
    pat = r"constexpr int CONSUMERS = (\d+);"
    n = int(re.search(pat, src).group(1))
    m = 3 - n
    cu = tmp / "window_other.cu"
    cu.write_text(re.sub(pat, f"constexpr int CONSUMERS = {m};", src))
    nvcc = _build._nvcc()
    objs = []
    for f in (cu, _build.CSRC / "status.cu"):
        obj = tmp / (f.stem + ".o")
        subprocess.run([nvcc, *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
                        "-c", str(f), "-o", str(obj)], check=True,
                       capture_output=True)
        objs.append(str(obj))
    lib = tmp / "libwindow_other.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                    *objs], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mxtt_paged_window_tc
    fn.argtypes, fn.restype = fd._WINDOW_TC.argtypes, ctypes.c_int
    return n, m, fn


def main() -> int:
    if not torch.cuda.is_available():
        print("window_consumers: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load_library()
    with tempfile.TemporaryDirectory() as tmp:
        n, m, other = build_other(Path(tmp))

        def run_other(q, kp, vp, bt, vl, scale):
            out = torch.empty_like(q)
            B, W, H, d = q.shape
            N, K, bs = kp.shape[:3]
            with torch.cuda.device(q.device):
                rc = other(out.data_ptr(), q.data_ptr(), kp.data_ptr(),
                           vp.data_ptr(), bt.data_ptr(), vl.data_ptr(), B, W,
                           H, K, d, bs, bt.shape[1], N, float(scale),
                           _build.dtype_code(q),
                           _build.stream_handle(q.device))
            if rc:
                raise RuntimeError(f"{m}-consumer window kernel failed to "
                                   f"launch ({rc})")
            return out

        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        rs = np.random.RandomState(cs.SEED + 6)
        H, K, d, bs = 32, 8, 128, cs.BLOCK_SIZE
        nb = cs.MAX_LEN // bs
        for label, vls in (
                ("chunk", np.arange(257, 513)[None]),
                ("verify", rs.randint(130, 501, cs.BATCH_SLOTS)[:, None]
                 + np.arange(1, 6))):
            B, W = vls.shape
            N = B * nb + 1
            q = torch.randn(B, W, H, d, generator=gen, device="cuda").bfloat16()
            kp, vp = (torch.randn(N, K, bs, d, generator=gen, device="cuda")
                      .bfloat16() for _ in range(2))
            bt = np.zeros((B, nb), np.int32)
            ids = 1 + rs.permutation(N - 1)
            for b in range(B):
                nblk = -(-int(vls[b].max()) // bs)
                bt[b, :nblk] = ids[b * nb:b * nb + nblk]
            bt = torch.from_numpy(bt).cuda()
            vl = torch.from_numpy(vls.astype(np.int32)).cuda()
            scale = 1.0 / math.sqrt(d)
            args = (q, kp, vp, bt, vl, scale)
            runs = {n: lambda: fd.flash_decode_paged_window(*args),
                    m: lambda: run_other(*args)}
            if not torch.equal(runs[n](), runs[m]()):
                print(f"window_consumers: {label}: {n} and {m} consumers "
                      f"differ", file=sys.stderr)
                return 1
            times = [(c, cs.cold_ms(torch, runs[c], flush))
                     for c in (n, m, m, n, n, m)]
            med = {c: float(np.median([t for cc, t in times if cc == c]))
                   for c in (n, m)}
            print(f"[window consumers] {label} B={B} W={W} H={H} K={K} d={d} "
                  f"bs={bs}: equal bit for bit; ms in turns "
                  + ", ".join(f"{c} consumers {t:.4f}" for c, t in times)
                  + f"; median {n} consumers {med[n]:.4f}, {m} consumers "
                  f"{med[m]:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
