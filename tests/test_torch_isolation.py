"""The torch port imports neither JAX nor anything of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dmesh_renderer_tpu_torch"
BLOCKED = ("jax", "jaxlib", "dmesh_renderer_tpu", "dmesh_renderer")


def _sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("port_*.py")))
    assert len(files) > 10 and all(f.exists() for f in files)
    for part in ("tools/exp_round3.py", "tools/proto_march_kernel.py",
                 "tools/fuzz_tri_parity.py", "tools/fuzz_tet_parity.py",
                 "tools/fuzz_common.py", "tools/tet_stages.py",
                 "utils/diagnostics.py", "parallel/sharding.py",
                 "parallel/launch.py", "utils/checkpoint.py"):
        assert PORT / part in files, part
    for name in ("port_optimize_triangles.py", "port_optimize_tet.py"):
        assert ROOT / "examples" / name in files, name
    return files


def test_no_jax_imports_in_port_sources():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in BLOCKED]
    assert not bad, bad


_PROBE = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import dmesh_renderer_tpu_torch as p
from dmesh_renderer_tpu_torch.utils.scenes import tri_scene
v, f, vc, fo, mv, proj, vd, fi = tri_scene(64, 1, 40, 40, seed=1)
r = p.TriRenderer(p.TriRenderSettings(40, 40, np.zeros(3, np.float32)),
                  device="cpu")
c, d = r(v, f, vc, fo, mv, proj, vd, fi)
assert c.shape == (1, 3, 40, 40) and bool((d < 1).any())
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene
import torch
*tet_args, bg = tet_scene(3, 1, 32, 32)
tet_args = [torch.from_numpy(x) for x in tet_args]
for i in (2, 3):
    tet_args[i].requires_grad_(True)
c, d, a = p.TetRenderer(p.TetRenderSettings(32, 32, bg), device="cpu")(
    *tet_args)
assert c.shape == (1, 3, 32, 32) and bool(a.any())
(c.sum() + d.sum()).backward()
assert bool(tet_args[2].grad.any() and tet_args[3].grad.any())
from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
from dmesh_renderer_tpu_torch.tools import proto_march_kernel as pm
from dmesh_renderer_tpu_torch.utils import diagnostics as dg
cpu = torch.device("cpu")
ex.e3(cpu, M=256)
march, mega, ct, consts, state = ex.e5_inputs(cpu, n_grid=2, M=300)
assert torch.equal(ex.mega_step(mega, ct, consts, state),
                   ex.two_table_step(march["tet_geo"], march["tet_ids"],
                                     march["shade"], ct, consts, state))
pm.chain(*pm.random_tables(cpu, M=256, T=30, F=70), steps=2)
st = dg.tri_render_stats(*[torch.from_numpy(x) for x in (v, f)],
                         torch.from_numpy(mv.transpose(0, 2, 1).copy()),
                         torch.from_numpy(proj.transpose(0, 2, 1).copy()),
                         40, 40)
assert st["num_rendered"] > 0 and dg.tet_health(a)["active_fraction"] > 0
import os, tempfile
from dmesh_renderer_tpu_torch import parallel
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.utils import checkpoint as ck
state = dmesh.init_tet_train_state(
    dmesh.TetScene(tet_args[2], tet_args[3]), torch.optim.Adam)
with tempfile.TemporaryDirectory() as d:
    ck.restore_checkpoint(ck.save_checkpoint(os.path.join(d, "c"), state),
                          state)
sys.path.insert(0, "examples")
import port_optimize_tet, port_optimize_triangles
from dmesh_renderer_tpu_torch.tools import fuzz_tet_parity, fuzz_tri_parity
assert fuzz_tri_parity.check_config(1016, cpu)[1] == []
assert fuzz_tet_parity.make_config(2000)[2:4] == (24, 24)
from dmesh_renderer_tpu_torch.tools import tet_stages
assert tet_stages.card_vs_cpu(cpu, *tet_stages.scene("odd_37x50")) == (
    None, [])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("OK")
"""


def test_import_and_render_with_jax_blocked():
    # the block matches top-level names exactly: dmesh_renderer_tpu_torch
    # shares a prefix with a blocked name and must still import
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
