"""The port stands alone: no module of `paddle_tpu_torch`, and none of
`chip_smoke.py`, `torch_serve_profile.py`, `torch_train_profile.py`,
`torch_flash_bench.py` and `torch_paged_bench.py`, imports JAX or anything
of the JAX package `paddle_tpu`.

Roots are compared exactly: ``"paddle_tpu_torch".startswith("paddle_tpu")``
holds, so a prefix test would wrongly flag the port's own imports."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / name for name in (
        "chip_smoke.py", "torch_serve_profile.py", "torch_train_profile.py",
        "torch_flash_bench.py", "torch_paged_bench.py")]


def _import_roots(path):
    """(line, root module) of every absolute import in `path`."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


def test_port_has_modules_and_a_smoke_script():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/ops/kv_quantize_scatter.py",
                 "paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/ops/fused_ce.py",
                 "paddle_tpu_torch/optimizer/optimizers.py",
                 "paddle_tpu_torch/serving/engine.py",
                 "paddle_tpu_torch/serving/server.py",
                 "paddle_tpu_torch/serving/frontend.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/models/lora.py",
                 "paddle_tpu_torch/serving/kv_tier.py",
                 "paddle_tpu_torch/quantization/adaround.py",
                 "paddle_tpu_torch/optimizer/lr.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/nn/clip.py",
                 "paddle_tpu_torch/amp/auto_cast.py",
                 "paddle_tpu_torch/amp/grad_scaler.py",
                 "paddle_tpu_torch/distributed/fleet/utils.py",
                 "paddle_tpu_torch/profiler/tracing.py",
                 "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_paddle_tpu_imports(path):
    bad = [(ln, root) for ln, root in _import_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_root_comparison_is_exact(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import paddle_tpu_torch.serving\n"
                 "from paddle_tpu.models import gpt\nimport jax.numpy\n")
    roots = [r for _, r in _import_roots(f)]
    assert roots == ["paddle_tpu_torch", "paddle_tpu", "jax"]
    assert [r for r in roots if r in FORBIDDEN] == ["paddle_tpu", "jax"]
