"""The port stands alone: no module under src/repro_torch (nor
chip_smoke.py) imports JAX or anything of the JAX package ``repro``."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps(bad))
"""


def port_modules():
    src = ROOT / "src"
    mods = []
    for f in sorted((src / "repro_torch").rglob("*.py")):
        parts = f.relative_to(src).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference():
    mods = port_modules()
    assert "repro_torch.core.engine" in mods and len(mods) > 20
    for sub in ("repro_torch.models.lm", "repro_torch.models.mind",
                "repro_torch.models.convert", "repro_torch.models.gnn.layers",
                "repro_torch.configs.minitron", "repro_torch.data.synthetic",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.embedding_bag.ops",
                "repro_torch.kernels.spmm_ell.ops", "repro_torch.kernels.spmm_ell.kernel",
                "repro_torch.models.gnn.gin", "repro_torch.models.gnn.ell",
                "repro_torch.models.gnn.batch", "repro_torch.configs.gin_tu",
                "repro_torch.configs.cells", "repro_torch.serve.router",
                "repro_torch.serve.updates", "repro_torch.obs.trace",
                "repro_torch.launch.serve", "repro_torch.tune",
                "repro_torch.tune.policies", "repro_torch.tune.controller",
                "repro_torch.tune.autotune", "repro_torch.obs.recorder",
                "repro_torch.obs.export", "repro_torch.launch.tune",
                "repro_torch.launch.obs", "repro_torch.launch.mesh",
                "repro_torch.core.ranks", "repro_torch.core.agm",
                "repro_torch.serve.stream", "repro_torch.configs",
                "repro_torch.configs.sssp_cfg", "repro_torch.configs.mind_cfg",
                "repro_torch.configs.phi3_mini", "repro_torch.launch.dryrun",
                "repro_torch.bench", "repro_torch.bench.variants",
                "repro_torch.bench.table1", "repro_torch.bench.scaling",
                "repro_torch.bench.run"):
        assert sub in mods, sub
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        modules=mods + ["chip_smoke"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
