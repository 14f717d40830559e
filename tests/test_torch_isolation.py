"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's examples import ``jax`` or anything
of the JAX package ``repro``, and importing the serving stack, Nimble's
core or the model families loads no JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401  (this test process has both frameworks)
import pytest  # noqa: E402
import torch  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "branchy_inference_torch.py", ROOT / "examples" / "serve_llm_torch.py",
    ROOT / "examples" / "train_lm_torch.py", ROOT / "tools" / "decode_variants.py",
    ROOT / "tools" / "adamw_faults.py", ROOT / "tools" / "train_phi4_step.py",
    ROOT / "tools" / "ce_faults.py", ROOT / "tools" / "stream_pack_variants.py",
    ROOT / "tools" / "mla_replays.py", ROOT / "tools" / "expanded_faults.py",
    ROOT / "tools" / "expanded_variants.py", ROOT / "tools" / "norm_rope_profile.py",
    ROOT / "tools" / "rms_bwd_variants.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_file_list_is_complete():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/serving/engine.py",
                 "src/repro_torch/kernels/flash_attention/kernel.py",
                 "src/repro_torch/launch/serve.py", "src/repro_torch/bridge.py",
                 "src/repro_torch/kernels/stream_pack/kernel.py",
                 "src/repro_torch/core/aot.py", "src/repro_torch/core/trace.py",
                 "src/repro_torch/core/rewriter.py", "src/repro_torch/models/branchy.py",
                 "src/repro_torch/models/moe.py", "src/repro_torch/models/mla.py",
                 "src/repro_torch/models/ssm.py", "src/repro_torch/models/xlstm.py",
                 "src/repro_torch/core/engine.py",
                 "src/repro_torch/configs/llava_next_34b.py",
                 "src/repro_torch/configs/seamless_m4t_medium.py",
                 "src/repro_torch/configs/zamba2_2_7b.py",
                 "src/repro_torch/configs/xlstm_125m.py",
                 "examples/quickstart_torch.py", "examples/branchy_inference_torch.py",
                 "src/repro_torch/dispatch/errors.py", "src/repro_torch/dispatch/lifecycle.py",
                 "src/repro_torch/dispatch/metrics.py", "src/repro_torch/dispatch/fairness.py",
                 "src/repro_torch/dispatch/slo.py", "src/repro_torch/dispatch/batching.py",
                 "src/repro_torch/dispatch/dispatcher.py", "src/repro_torch/dispatch/journal.py",
                 "src/repro_torch/dispatch/workers.py",
                 "src/repro_torch/dispatch/async_dispatcher.py",
                 "src/repro_torch/obs/export.py", "src/repro_torch/obs/registry.py",
                 "src/repro_torch/serving/spec.py", "src/repro_torch/core/capture.py",
                 "examples/serve_llm_torch.py",
                 "src/repro_torch/optim/adamw.py", "src/repro_torch/optim/schedules.py",
                 "src/repro_torch/training/train_lib.py", "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/store.py", "src/repro_torch/launch/train.py",
                 "src/repro_torch/kernels/flash_attention/backward.py",
                 "examples/train_lm_torch.py",
                 "src/repro_torch/configs/shapes.py", "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/distributed/__init__.py", "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/comm_analysis.py",
                 "src/repro_torch/kernels/decode_attention/kernel.py",
                 "src/repro_torch/kernels/decode_attention/ref.py",
                 "src/repro_torch/kernels/decode_attention/ops.py",
                 "src/repro_torch/kernels/adamw/kernel.py",
                 "src/repro_torch/kernels/adamw/ref.py", "tools/adamw_faults.py",
                 "tools/train_phi4_step.py",
                 "src/repro_torch/kernels/cross_entropy/kernel.py",
                 "src/repro_torch/kernels/cross_entropy/ref.py",
                 "src/repro_torch/kernels/cross_entropy/ops.py", "tools/ce_faults.py",
                 "tools/stream_pack_variants.py",
                 "src/repro_torch/kernels/latent_attention/kernel.py",
                 "src/repro_torch/kernels/latent_attention/ref.py", "tools/mla_replays.py",
                 "src/repro_torch/kernels/expanded_attention/kernel.py",
                 "src/repro_torch/kernels/expanded_attention/backward.py",
                 "src/repro_torch/kernels/expanded_attention/ops.py",
                 "src/repro_torch/kernels/expanded_attention/ref.py", "tools/expanded_faults.py",
                 "tools/expanded_variants.py", "src/repro_torch/kernels/rms_norm/kernel.py",
                 "src/repro_torch/kernels/rms_norm/backward.py",
                 "src/repro_torch/kernels/rms_norm/ops.py",
                 "src/repro_torch/kernels/rms_norm/ref.py",
                 "src/repro_torch/kernels/rotary/kernel.py",
                 "src/repro_torch/kernels/rotary/ops.py", "src/repro_torch/kernels/rotary/ref.py",
                 "tools/norm_rope_profile.py"):
        assert must in names


def test_importing_the_serving_stack_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.serving, repro_torch.launch.serve, repro_torch.bridge\n"
        "import repro_torch.core, repro_torch.models.branchy, repro_torch.kernels.stream_pack\n"
        "import repro_torch.models.ssm, repro_torch.models.xlstm\n"
        "import repro_torch.dispatch, repro_torch.obs, repro_torch.serving.spec\n"
        "import repro_torch.training, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.launch.train\n"
        "import repro_torch.distributed, repro_torch.configs.shapes\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.kernels.rms_norm, repro_torch.kernels.rotary\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
