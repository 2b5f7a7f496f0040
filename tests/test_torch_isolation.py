"""The port stands alone: no module of src/repro_torch, and not
chip_smoke.py, imports JAX or the JAX package, and its entry points never
run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]       # "repro_torch" is not "repro"
    return top in FORBIDDEN


def test_no_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), n) for f in files
           for n in _imported(f) if _forbidden(n)]
    assert bad == []


def test_forbidden_rule_keeps_the_port_prefix_apart():
    assert _forbidden("repro.api") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.api")


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.launch.serve, repro_torch.api.bridge\n"
            "import repro_torch.kernels.ops\n"
            "import repro_torch.launch.train, repro_torch.train.loop\n"
            "import repro_torch.core.wsi, repro_torch.core.orthogonal\n"
            "import repro_torch.kernels.gram, repro_torch.kernels.qr\n"
            "import repro_torch.nn.losses, repro_torch.optim\n"
            "import repro_torch.data.synthetic\n"
            "import repro_torch.checkpoint, repro_torch.quant\n"
            "import repro_torch.api.convert, repro_torch.kernels.quant\n"
            "import repro_torch.core.asi, repro_torch.core.lowrank_linear\n"
            "import repro_torch.kernels.matmul_tiled\n"
            "import repro_torch.utils.memprof\n"
            "import repro_torch.core.svd, repro_torch.core.project\n"
            "import repro_torch.models.vit, repro_torch.configs.vit_base\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.serve.kvpool\n"
            "import repro_torch.tenancy, repro_torch.tenancy.resident\n"
            "import repro_torch.launch.finetune_user\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch import configs
    from repro_torch.models.lm import init_lm, init_lm_cache, init_lm_states
    from repro_torch.serve import ServeEngine

    cfg = configs.get_smoke("qwen2-0.5b")
    model = init_lm(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_states(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, cfg, max_slots=1, max_cache=16)
    # asking for the CPU explicitly is fine
    ServeEngine(model, cfg, max_slots=1, max_cache=16, device="cpu")


def test_vit_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch import configs
    from repro_torch.models.vit import init_vit, init_vit_states

    cfg = configs.get_smoke("vit-base")
    init_vit(cfg, 4, 24, 16, device="cpu")
    init_vit_states(cfg, 2, 16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_vit(cfg, 4, 24, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_vit_states(cfg, 2, 16)
