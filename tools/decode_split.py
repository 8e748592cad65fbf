#!/usr/bin/env python3
"""Time the contiguous decode kernels (`csrc/decode_attention.cu`,
`mxtt_contig_decode` and `mxtt_contig_decode_q8`) with a split walk of
64, 128 and 256 tokens a block, on one CUDA card:

    python3 tools/decode_split.py

A copy of the source is built for each SPLIT (one nvcc each, started
together). At generate()'s shape in `chip_smoke.py` (B=8, H=32, K=8,
d=128, S=544, valid lengths drawn as its kernels phase draws them, bf16
q, a bf16 and an int8 cache) every variant runs on the same inputs and
is held to `chip_smoke.decode_tol` of the plain version, then timed
with a cold L2 (`chip_smoke.cold_ms`) in turns 64, 128, 256, 256, 128,
64, twice. Prints the card's name and power limit and one line a cache.
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

SPLITS = (64, 128, 256)
PAT = r"constexpr int SPLIT = (\d+);"


def build_variants(tmp: Path):
    """{SPLIT: (contig entry point, q8 entry point)}, one library each."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    nvcc = _build._nvcc()
    jobs = {}
    for n in SPLITS:
        cu = tmp / f"decode_split_{n}.cu"
        cu.write_text(re.sub(PAT, f"constexpr int SPLIT = {n};", src))
        jobs[n] = (cu, tmp / f"decode_split_{n}.o")
    status = tmp / "status.o"
    procs = [subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-I",
                               str(_build.CSRC), "-c", str(c), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, o in list(jobs.values())
             + [(_build.CSRC / "status.cu", status)]]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out}")
    fns = {}
    for n, (_, obj) in jobs.items():
        lib = tmp / f"libdecode_split_{n}.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                        str(obj), str(status)], check=True,
                       capture_output=True)
        dll = ctypes.CDLL(str(lib))
        pair = []
        for kern in (fd._CONTIG, fd._CONTIG_Q8):
            fn = getattr(dll, kern.symbol)
            fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
            pair.append(fn)
        fns[n] = tuple(pair)
    return fns


def run(fn, split, q, cache, vl, scale):
    """One call of a variant: its own workspace, then the launch."""
    B, H, d = q.shape
    K, S = cache[0].shape[1], cache[0].shape[2]
    out = torch.empty_like(q)
    ws = torch.empty((B, K, -(-S // split), H // K, d + 2),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(out.data_ptr(), q.data_ptr(),
                *(t.data_ptr() for t in cache), vl.data_ptr(), ws.data_ptr(),
                B, H, K, d, S, float(scale), _build.dtype_code(q),
                _build.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"SPLIT={split}: launch failed ({rc})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        seed = cs.SEED + 3
        gen = torch.Generator(device="cuda").manual_seed(seed)
        rs = np.random.RandomState(seed)
        B, H, K, d = cs.BATCH_SLOTS, 32, 8, 128
        S = cs.MAX_PROMPT + cs.NEW_TOKENS
        vl = torch.tensor(rs.randint(33, S + 1, B).astype(np.int32)).cuda()
        q = torch.randn(B, H, d, generator=gen, device="cuda").bfloat16()
        k = cs.cache_rows(torch, gen, (B, K, S, d), torch.bfloat16, 0.5)
        v = cs.cache_rows(torch, gen, (B, K, S, d), torch.bfloat16, 1.5)
        scale = 1.0 / math.sqrt(d)
        k8, ks, v8, vs = fd.quantize_kv(k, v)
        for label, which, cache, plain, deq in (
                ("bf16 cache", 0, (k, v),
                 fd.reference_decode_attention(q, k, v, vl, scale), (k, v)),
                ("int8 cache", 1, (k8, ks, v8, vs),
                 fd.reference_decode_quantized(q, k8, ks, v8, vs, vl,
                                               scale),
                 (fd.dequantize_kv(k8, ks, torch.float32),
                  fd.dequantize_kv(v8, vs, torch.float32)))):
            tol = cs.decode_tol(torch, q, *deq, vl, plain, scale)
            calls = {n: (lambda n=n: run(fns[n][which], n, q, cache, vl,
                                         scale)) for n in SPLITS}
            errs = {n: cs.held(torch, f"SPLIT={n} {label}", calls[n](),
                               plain, tol)[0] for n in SPLITS}
            order = SPLITS + SPLITS[::-1]
            times = [(n, cs.cold_ms(torch, calls[n], flush))
                     for n in order + order]
            med = {n: float(np.median([t for m, t in times if m == n]))
                   for n in SPLITS}
            print(f"[decode split] {label} B={B} H={H} K={K} d={d} S={S} "
                  f"valid_len={vl.tolist()}: every SPLIT within "
                  f"decode_tol (max_abs_err "
                  + ", ".join(f"{n}: {errs[n]:.3g}" for n in SPLITS)
                  + "); ms in turns "
                  + ", ".join(f"{n}: {t:.4f}" for n, t in times)
                  + "; median " + ", ".join(f"SPLIT={n} {med[n]:.4f}"
                                            for n in SPLITS)
                  + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
