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
            "from mxnet_tpu_torch.models import get_model\n"
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


def test_chip_smoke_refuses_without_cuda():
    """No card: exit non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
