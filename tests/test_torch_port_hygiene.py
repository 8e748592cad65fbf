"""The port stands alone: no file of `mxnet_tpu_torch/` (nor
`chip_smoke.py`) imports JAX or the JAX package, the package imports
with JAX unavailable, and its entry points refuse to fall back to the
CPU when CUDA is absent and the CPU was not asked for."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['mxnet_tpu'] = None\n"
            "import mxnet_tpu_torch, mxnet_tpu_torch.serving\n"
            "from mxnet_tpu_torch.serving import InferenceServer\n"
            "from mxnet_tpu_torch.serving import NgramProposer, as_proposer\n"
            "from mxnet_tpu_torch.models import get_model\n"
            "import mxnet_tpu_torch.gluon, mxnet_tpu_torch.optimizer\n"
            "import mxnet_tpu_torch.parallel\n"
            "from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss\n"
            "from mxnet_tpu_torch.optimizer import SGD, Adam, AdamW\n"
            "from mxnet_tpu_torch.parallel import FusedTrainStep\n"
            "from mxnet_tpu_torch.amp import convert_block\n"
            "from mxnet_tpu_torch.gluon.nn import Dense, LayerNorm\n"
            "from mxnet_tpu_torch.models.bert import bert_base\n"
            "from mxnet_tpu_torch.models.transformer import TransformerMT\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_cpu_fallback_without_cuda(monkeypatch):
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.serving import InferenceServer, PagedKVCache
    net = get_model("llama_tiny", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("llama_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(num_layers=1, num_kv_heads=1, head_dim=8, num_blocks=2,
                     block_size=4, batch_slots=1, max_blocks_per_seq=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    # a CPU net behind a server asked to run elsewhere is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="weights are on cpu"):
        InferenceServer(net, device="cuda")


@pytest.mark.parametrize("name", ["bert_base", "bert_tiny",
                                  "transformer_base", "transformer_tiny"])
def test_bert_and_transformer_refuse_cpu_fallback_without_cuda(
        name, monkeypatch):
    from mxnet_tpu_torch.models import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(name)


def test_generate_refuses_cpu_fallback_without_cuda(monkeypatch):
    from mxnet_tpu_torch.models import generate, generate_beam, get_model
    net = get_model("llama_tiny", device="cpu")
    prompt = np.zeros((1, 3), np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (generate, generate_beam):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(net, prompt, 2)
    assert generate(net, prompt, 2, device="cpu").shape == (1, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="weights are on cpu"):
        generate(net, prompt, 2, device="cuda")


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lengths_shape",
                                 "lengths_dtype", "strided_q"])
def test_window_wrapper_raises_on_the_card_and_never_falls_back(
        bad, monkeypatch):
    """`flash_decode_paged_window` on a tensor that is not on the CPU
    launches its kernel or raises: an operand the kernel does not take
    raises before any launch, and the plain version is never called.
    Tensors on the `meta` device stand in for card tensors here (the
    wrapper only takes the plain version for `cpu`)."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_decode as fd

    def fell_back(*a, **k):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fd, "reference_paged_window_attention", fell_back)
    monkeypatch.setattr(fd, "reference_window_attention", fell_back)
    _build.reset_launch_counts()
    meta = torch.device("meta")
    B, W, H, K, d = 2, 5, 4, 2, 64 if bad == "head_dim" else 16
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q = torch.empty(B, W, H, d, dtype=dtype, device=meta)
    if bad == "strided_q":
        q = torch.empty(B, H, W, d, device=meta).transpose(1, 2)
    pool = torch.empty(9, K, 8, d, dtype=dtype, device=meta)
    bt = torch.empty(B, 4, dtype=torch.int32, device=meta)
    vls = torch.empty((B,) if bad == "lengths_shape" else (B, W),
                      dtype=torch.int64 if bad == "lengths_dtype"
                      else torch.int32, device=meta)
    with pytest.raises((ValueError, TypeError)):
        fd.flash_decode_paged_window(q, pool, pool, bt, vls)
    assert _build.launch_counts()["mxtt_paged_window"] == 0
    assert _build._lib is None


# -- C1: no route cuts autograd on the card -----------------------------------

META = torch.device("meta")


def _decode_operands(route):
    """Operands of a decode or window wrapper on `meta` tensors standing
    in for card tensors, q requiring a gradient."""
    B, H, K, d, W = 2, 4, 2, 16, 3
    q = torch.empty((B, W, H, d) if route.endswith("window") else (B, H, d),
                    device=META, requires_grad=True)
    i32 = dict(dtype=torch.int32, device=META)
    vl = torch.empty((B, W) if route.endswith("window") else (B,), **i32)
    paged = "paged" in route
    shape = (9, K, 8, d) if paged else (B, K, 24, d)
    if "quantized" in route:
        c8 = torch.empty(shape, dtype=torch.int8, device=META)
        sc = torch.empty(shape[:3] + (1,), device=META)
        cache = (c8, sc, c8, sc)
    else:
        cache = (torch.empty(shape, device=META),) * 2
    tables = (torch.empty(B, 4, **i32),) if paged else ()
    return (q,) + cache + tables + (vl,)


DECODE_ROUTES = ["flash_decode", "flash_decode_quantized",
                 "flash_decode_paged", "flash_decode_paged_quantized",
                 "flash_decode_paged_window"]


@pytest.fixture
def stub_launch(monkeypatch):
    """Launches on `meta` tensors recorded by symbol (and counted), never
    sent to a library."""
    from mxnet_tpu_torch.kernels import _build
    launched = []

    def launch(kernel, device, *args):
        launched.append(kernel.symbol)
        kernel.launches += 1
    monkeypatch.setattr(_build, "launch", launch)
    _build.reset_launch_counts()
    return launched


@pytest.mark.parametrize("route", DECODE_ROUTES)
def test_decode_routes_raise_where_autograd_needs_a_gradient(route,
                                                             stub_launch):
    """The decode and window kernels have no backward: with grad enabled
    and an input requiring a gradient the wrapper raises before any
    launch; under no_grad the same call launches once."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    ops = _decode_operands(route)
    with pytest.raises(RuntimeError, match="has no backward"):
        getattr(fd, route)(*ops)
    assert stub_launch == []
    with torch.no_grad():
        out = getattr(fd, route)(*ops)
    assert len(stub_launch) == 1 and out.grad_fn is None


@pytest.mark.parametrize("S", [24, 64, 65, 544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,symbol", [
    ("flash_decode", "mxtt_contig_decode"),
    ("flash_decode_quantized", "mxtt_contig_decode_q8")])
def test_contiguous_decode_launches_once_with_a_split_workspace(
        route, symbol, dtype, S, monkeypatch):
    """One call, one counted launch (the split walk and its merge are one
    C call) with every C argument but the stream, and an fp32 workspace
    of (B, K, ceil(S / SPLIT), rep, d + 2) sized from S alone: valid_len
    lies on `meta`, where any copy to the host raises."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_decode as fd
    launched, spaces = [], []

    def launch(kernel, device, *args):
        launched.append((kernel.symbol, len(args) + 1 == len(kernel.argtypes)))
        kernel.launches += 1

    def workspace(q, K, S_):
        spaces.append(real(q, K, S_))
        return spaces[-1]
    real = fd._split_workspace
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(fd, "_split_workspace", workspace)
    _build.reset_launch_counts()
    B, H, K, d = 3, 8, 2, 128
    q = torch.empty(B, H, d, dtype=dtype, device=META)
    vl = torch.empty(B, dtype=torch.int32, device=META)
    if route == "flash_decode":
        cache = (torch.empty(B, K, S, d, dtype=dtype, device=META),) * 2
    else:
        c8 = torch.empty(B, K, S, d, dtype=torch.int8, device=META)
        sc = torch.empty(B, K, S, 1, device=META)
        cache = (c8, sc, c8, sc)
    with pytest.raises(NotImplementedError):
        vl.tolist()                      # meta: no host copy
    out = getattr(fd, route)(q, *cache, vl)
    assert launched == [(symbol, True)]
    assert _build.launch_counts()[symbol] == 1
    assert out.shape == q.shape and out.dtype == dtype
    assert len(spaces) == 1 and spaces[0].dtype == torch.float32
    assert tuple(spaces[0].shape) == (B, K, -(-S // fd.SPLIT), H // K, d + 2)


@pytest.mark.parametrize("route,bad", [
    (route, bad)
    for route in ("flash_decode", "flash_decode_quantized")
    for bad in ("q_dtype", "cache_dtype", "cache_shape", "lengths_shape",
                "lengths_dtype", "lengths_rows", "k_misaligned", "v_strided",
                "rep_too_wide")]
    + [("flash_decode_quantized", "scale_shape"),
       ("flash_decode_quantized", "scale_dtype")])
def test_contiguous_decode_raises_before_any_launch(route, bad, stub_launch):
    """What the split kernels cannot take (a dtype, a shape, a cache off a
    16-byte boundary or not contiguous, rep * d past MAX_REP_DIM) raises
    before any launch: no detour to the plain version."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    B, K, S, d = 2, 2, 40, 128
    H = 18 if bad == "rep_too_wide" else 8     # rep * d = 1152 > 1024
    q = torch.empty(B, H, d, device=META,
                    dtype=torch.float16 if bad == "q_dtype" else torch.float32)
    q8 = route == "flash_decode_quantized"
    cdt = torch.int8 if q8 else torch.float32
    if bad == "cache_dtype":
        cdt = torch.float32 if q8 else torch.bfloat16
    shape = (B, K, S, d + 16 if bad == "cache_shape" else d)
    k = torch.empty(shape, device=META, dtype=cdt)
    if bad == "k_misaligned":   # one element past a 16-byte boundary
        n = int(np.prod(shape))
        k = torch.empty(n + 1, device=META, dtype=cdt)[1:].view(shape)
    v = torch.empty(B, K, d, S, device=META, dtype=cdt).transpose(2, 3) \
        if bad == "v_strided" else torch.empty(shape, device=META, dtype=cdt)
    vl = torch.empty({"lengths_shape": (B, 1), "lengths_rows": (B + 1,)}
                     .get(bad, (B,)), device=META,
                     dtype=torch.int64 if bad == "lengths_dtype"
                     else torch.int32)
    sc = torch.empty(B, K, S + (bad == "scale_shape"), 1, device=META,
                     dtype=torch.bfloat16 if bad == "scale_dtype"
                     else torch.float32)
    args = (k, sc, v, sc, vl) if q8 else (k, v, vl)
    with pytest.raises((ValueError, TypeError)):
        getattr(fd, route)(q, *args)
    assert stub_launch == []


@pytest.mark.parametrize("route", ["rmsnorm", "layernorm",
                                   "flash_attention", "softmax_ce"])
def test_training_routes_keep_the_graph_on_the_card(route, stub_launch):
    """The training step's kernels go through their autograd Functions on
    the card: the output has the Function's grad_fn, and a backward
    launches the backward kernels and reaches every input with its own
    shape."""
    from mxnet_tpu_torch.kernels import flash_attention, fused_ce, fused_norm
    g = dict(device=META, requires_grad=True)
    if route == "rmsnorm":
        ins = (torch.empty(2, 3, 64, **g), torch.empty(64, **g))
        out = fused_norm.rmsnorm(*ins, 1e-5)
        want = ["mxtt_rmsnorm", "mxtt_rmsnorm_dx"]
    elif route == "layernorm":
        ins = (torch.empty(2, 3, 64, **g), torch.empty(64, **g),
               torch.empty(64, **g))
        out = fused_norm.layernorm(*ins, 1e-5)
        want = ["mxtt_layernorm", "mxtt_layernorm_dx"]
    elif route == "flash_attention":
        ins = (torch.empty(1, 8, 4, 16, **g), torch.empty(1, 8, 2, 16, **g),
               torch.empty(1, 8, 2, 16, **g))
        out = flash_attention.flash_attention(*ins)
        want = ["mxtt_flash_prefill", "mxtt_flash_bwd_dq",
                "mxtt_flash_bwd_dkv"]
    else:
        ins = (torch.empty(4, 1024, **g),)
        out = fused_ce.softmax_ce(
            ins[0], torch.empty(4, dtype=torch.int64, device=META))
        want = ["mxtt_ce_fwd", "mxtt_ce_bwd"]
    assert type(out.grad_fn).__name__.endswith("FunctionBackward")
    assert stub_launch == want[:1]
    out.backward(torch.ones_like(out))
    assert stub_launch == want
    for t in ins:
        assert t.grad is not None and t.grad.shape == t.shape


@pytest.mark.parametrize("dtype,d,fwd,dq,dkv", [
    (torch.bfloat16, 64, "mxtt_flash_fwd_tc", "mxtt_flash_bwd_dq_tc",
     "mxtt_flash_bwd_dkv_tc"),
    (torch.bfloat16, 128, "mxtt_flash_fwd_tc", "mxtt_flash_bwd_dq_tc",
     "mxtt_flash_bwd_dkv_tc"),
    (torch.bfloat16, 16, "mxtt_flash_prefill", "mxtt_flash_bwd_dq",
     "mxtt_flash_bwd_dkv"),
    (torch.float32, 64, "mxtt_flash_prefill", "mxtt_flash_bwd_dq",
     "mxtt_flash_bwd_dkv"),
    (torch.float32, 128, "mxtt_flash_prefill", "mxtt_flash_bwd_dq",
     "mxtt_flash_bwd_dkv")])
def test_attention_routes_by_dtype_and_head_dim(dtype, d, fwd, dq, dkv,
                                                stub_launch):
    """bf16 at d in {64, 128} takes the tensor-core forward, dq and dkv
    kernels; fp32 and d = 16 the SIMT ones. The Function keeps its
    grad_fn, and its backward reaches q, k and v with their own
    shapes."""
    from mxnet_tpu_torch.kernels import flash_attention
    g = dict(device=META, dtype=dtype, requires_grad=True)
    ins = (torch.empty(2, 8, 4, d, **g), torch.empty(2, 8, 2, d, **g),
           torch.empty(2, 8, 2, d, **g))
    out = flash_attention.flash_attention(*ins)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert stub_launch == [fwd]
    out.backward(torch.ones_like(out))
    assert stub_launch == [fwd, dq, dkv]
    for t in ins:
        assert t.grad is not None and t.grad.shape == t.shape
    with torch.no_grad():
        flash_attention.flash_attention(*ins)
    assert stub_launch[-1] == fwd


@pytest.mark.parametrize("dtype,d,rep,bs,kernel", [
    (torch.bfloat16, 128, 4, 16, "mxtt_paged_window_tc"),
    (torch.bfloat16, 64, 1, 8, "mxtt_paged_window_tc"),
    (torch.bfloat16, 128, 8, 64, "mxtt_paged_window_tc"),
    (torch.bfloat16, 128, 2, 32, "mxtt_paged_window_tc"),
    (torch.bfloat16, 16, 4, 16, "mxtt_paged_window"),
    (torch.bfloat16, 128, 3, 16, "mxtt_paged_window"),
    (torch.bfloat16, 128, 16, 16, "mxtt_paged_window"),
    (torch.bfloat16, 128, 4, 4, "mxtt_paged_window"),
    (torch.bfloat16, 128, 4, 128, "mxtt_paged_window"),
    (torch.float32, 128, 4, 16, "mxtt_paged_window"),
    (torch.float32, 16, 2, 8, "mxtt_paged_window"),
    (torch.bfloat16, 64, 3, 16, None),
    (torch.float32, 64, 4, 16, None)])
def test_window_routes_by_dtype_head_dim_rep_and_block_size(
        dtype, d, rep, bs, kernel, stub_launch):
    """bf16 at d in {64, 128}, H/K in {1, 2, 4, 8} and block size in {8,
    16, 32, 64} takes the tensor-core window kernel; every other call the
    SIMT one, which takes d in {16, 128}; what neither takes raises before
    any launch. The route follows from the operands alone."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_decode as fd
    B, W, K = 2, 5, 2
    q = torch.empty(B, W, K * rep, d, dtype=dtype, device=META)
    pool = torch.empty(9, K, bs, d, dtype=dtype, device=META)
    bt = torch.empty(B, 4, dtype=torch.int32, device=META)
    vls = torch.empty(B, W, dtype=torch.int32, device=META)
    if kernel is None:
        with pytest.raises(ValueError, match="head dim 64"):
            fd.flash_decode_paged_window(q, pool, pool, bt, vls)
        assert stub_launch == []
        return
    out = fd.flash_decode_paged_window(q, pool, pool, bt, vls)
    assert stub_launch == [kernel] and out.shape == q.shape
    assert _build.launch_counts()[kernel] == 1


@pytest.mark.parametrize("bad", ["q_misaligned", "k_misaligned",
                                 "v_strided", "table_dtype", "table_rows",
                                 "lengths_shape", "pool_too_large"])
def test_window_tensor_core_route_raises_before_any_launch(bad,
                                                           stub_launch):
    """A call on the tensor-core window route with an operand off a
    16-byte boundary, a non-contiguous pool, a bad table or lengths, or a
    pool past the kernel's 2^31 rows raises before any launch: no detour
    to the SIMT kernel or the plain version."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    bf = dict(device=META, dtype=torch.bfloat16)
    B, W, H, K, d, bs = 2, 5, 8, 2, 128, 16

    def misaligned(shape):      # one element past a 16-byte boundary
        n = int(np.prod(shape))
        return torch.empty(n + 1, **bf)[1:].view(shape)
    q = misaligned((B, W, H, d)) if bad == "q_misaligned" \
        else torch.empty(B, W, H, d, **bf)
    N = 2 ** 31 // (K * bs) if bad == "pool_too_large" else 9
    k = misaligned((N, K, bs, d)) if bad == "k_misaligned" \
        else torch.empty(N, K, bs, d, **bf)
    v = torch.empty(N, K, d, bs, **bf).transpose(2, 3) \
        if bad == "v_strided" else torch.empty(N, K, bs, d, **bf)
    bt = torch.empty(B + (bad == "table_rows"), 4, device=META,
                     dtype=torch.int64 if bad == "table_dtype"
                     else torch.int32)
    vls = torch.empty((B,) if bad == "lengths_shape" else (B, W),
                      dtype=torch.int32, device=META)
    with pytest.raises((ValueError, TypeError)):
        fd.flash_decode_paged_window(q, k, v, bt, vls)
    assert stub_launch == []


@pytest.mark.parametrize("bad", ["q_misaligned", "k_strided",
                                 "dout_misaligned", "lse_strided",
                                 "dq_dout_misaligned"])
def test_tensor_core_route_raises_before_any_launch(bad, stub_launch):
    """What the tensor-core kernels cannot take (a row off a 16-byte
    boundary, a non-contiguous operand) raises before any launch, as on
    the SIMT route: no detour to another kernel or the plain version."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    bf = dict(device=META, dtype=torch.bfloat16)
    shape_q, shape_k = (2, 8, 4, 64), (2, 8, 2, 64)

    def misaligned(shape):      # one element past a 16-byte boundary
        n = int(np.prod(shape))
        return torch.empty(n + 1, **bf)[1:].view(shape)
    q = misaligned(shape_q) if bad == "q_misaligned" \
        else torch.empty(shape_q, **bf)
    k = torch.empty(2, 8, 64, 2, **bf).transpose(2, 3) \
        if bad == "k_strided" else torch.empty(shape_k, **bf)
    if bad in ("q_misaligned", "k_strided"):
        with pytest.raises(ValueError):
            fa.flash_attention_forward(q, k, k, return_lse=True)
    else:
        dout = misaligned(shape_q) if bad.endswith("dout_misaligned") \
            else q
        stats = torch.empty(2, 4, 8, device=META)
        lse = torch.empty(2, 8, 4, device=META).transpose(1, 2) \
            if bad == "lse_strided" else stats
        bwd = fa.flash_bwd_dq if bad.startswith("dq_") else fa.flash_bwd_dkv
        with pytest.raises(ValueError):
            bwd(q, k, k, dout, lse, stats)
    assert stub_launch == []


@pytest.mark.parametrize("bad", ["rms_gamma_dtype", "rms_too_wide",
                                 "rms_dx_rrms_rows",
                                 "ln_gamma_dtype", "ln_strided_x",
                                 "fwd_lse_head_dim", "dq_lse_shape",
                                 "dkv_delta_dtype", "dkv_strided_dout",
                                 "ce_labels_dtype", "ce_bwd_dloss_rows"])
def test_training_wrappers_raise_on_the_card_and_never_fall_back(
        bad, monkeypatch):
    """Each wrapper of the training step's kernels, on `meta` tensors
    standing in for card tensors, raises on an operand its kernel does
    not take: no launch, no library, and the plain version never
    called."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_ce, fused_norm

    def fell_back(*a, **k):
        raise AssertionError("fell back to the plain version")
    for mod, names in ((fused_norm, ("rmsnorm_fwd_ref", "rmsnorm_dx_ref",
                                     "layernorm_fwd_ref",
                                     "layernorm_dx_ref")),
                       (fa, ("reference_attention",
                             "reference_attention_lse", "flash_bwd_dq_ref",
                             "flash_bwd_dkv_ref")),
                       (fused_ce, ("ce_fwd_ref", "ce_bwd_ref"))):
        for n in names:
            monkeypatch.setattr(mod, n, fell_back)
    _build.reset_launch_counts()
    f32 = dict(device=META)
    x = torch.empty(6, 64, **f32)
    g32 = torch.empty(64, **f32)
    d = 32 if bad == "fwd_lse_head_dim" else 16
    q = torch.empty(2, 8, 4, d, **f32)
    k = torch.empty(2, 8, 2, d, **f32)
    stats = torch.empty(2, 4, 8, **f32)
    dout = torch.empty(2, 4, 8, d, **f32).transpose(1, 2) \
        if bad == "dkv_strided_dout" else q
    lbl = torch.empty(6, dtype=torch.int64 if bad == "ce_labels_dtype"
                      else torch.int32, device=META)
    with pytest.raises((ValueError, TypeError)):
        if bad == "rms_gamma_dtype":
            fused_norm.rmsnorm_fwd(x, g32.bfloat16(), 1e-5)
        elif bad == "rms_too_wide":
            w = fused_norm.RMS_MAX_DIM + 8
            fused_norm.rmsnorm_fwd(torch.empty(2, w, **f32),
                                   torch.empty(w, **f32), 1e-5)
        elif bad == "rms_dx_rrms_rows":
            fused_norm.rmsnorm_dx(x, g32, torch.empty(5, **f32), x)
        elif bad == "ln_gamma_dtype":
            fused_norm.layernorm_fwd(x, g32.bfloat16(), g32, 1e-5)
        elif bad == "ln_strided_x":
            fused_norm.layernorm_dx(torch.empty(64, 6, **f32).t(), g32,
                                    torch.empty(6, **f32),
                                    torch.empty(6, **f32), x)
        elif bad == "fwd_lse_head_dim":
            fa.flash_attention_forward(q, k, k, return_lse=True)
        elif bad == "dq_lse_shape":
            fa.flash_bwd_dq(q, k, k, q, torch.empty(2, 8, 4, **f32), stats)
        elif bad in ("dkv_delta_dtype", "dkv_strided_dout"):
            delta = stats.double() if bad == "dkv_delta_dtype" else stats
            fa.flash_bwd_dkv(q, k, k, dout, stats, delta)
        elif bad == "ce_labels_dtype":
            fused_ce.ce_fwd(x, lbl)
        else:
            fused_ce.ce_bwd(x, lbl, torch.empty(6, **f32),
                            torch.empty(5, **f32))
    assert all(n == 0 for n in _build.launch_counts().values())
    assert _build._lib is None


def test_chip_smoke_refuses_without_cuda():
    """No card: exit non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
