"""The port's parity fuzz harnesses (``dmesh_renderer_tpu_torch/tools/
fuzz_tri_parity.py`` and ``fuzz_tet_parity.py``) against the JAX package's
(``tools/``): the same configs bit for bit, clean checks on the CPU for
seeds that cover every family, and failures reported."""

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch.tools import fuzz_common
from dmesh_renderer_tpu_torch.tools import fuzz_tet_parity as ptet
from dmesh_renderer_tpu_torch.tools import fuzz_tri_parity as ptri

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, imported by path once. Its
    import puts the repository and ``tests/`` on ``sys.path`` and may set
    ``DMRT_CHUNK``; both are restored."""
    key = f"jax_tool_{name}"
    if key not in sys.modules:
        path, env = list(sys.path), os.environ.get("DMRT_CHUNK")
        try:
            spec = importlib.util.spec_from_file_location(
                key, ROOT / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[key] = mod
        finally:
            sys.path[:] = path
            if env is None:
                os.environ.pop("DMRT_CHUNK", None)
            else:
                os.environ["DMRT_CHUNK"] = env
    return sys.modules[key]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("harness", ["tri", "tet"])
def test_make_config_bit_equal_to_jax(harness):
    """Every config of the JAX harnesses' default sweeps (tri seeds
    1000-1039, tet 2000-2029): the same arrays, bit for bit and dtype for
    dtype, the same image size and the same label."""
    if harness == "tri":
        jax_tool = _jax_tool("fuzz_tri_parity")
        for seed in range(1000, 1040):
            args_j, h_j, w_j, label_j = jax_tool.make_config(seed)
            args_p, h_p, w_p, label_p = ptri.make_config(seed)
            assert (h_p, w_p, label_p) == (h_j, w_j, label_j)
            assert len(args_p) == len(args_j) == 11
            for i, (a, b) in enumerate(zip(args_p, args_j)):
                assert _bits_equal(a, b), (seed, i)
    else:
        jax_tool = _jax_tool("fuzz_tet_parity")
        for seed in range(2000, 2030):
            sc_j, b_j, label_j = jax_tool.make_config(seed)
            sc_p, b_p, h, w, label_p = ptet.make_config(seed)
            assert (b_p, label_p, h, w) == (b_j, label_j, jax_tool.H,
                                            jax_tool.W)
            assert len(sc_p) == len(sc_j) == 11
            for i, (a, b) in enumerate(zip(sc_p, sc_j)):
                assert _bits_equal(a, b), (seed, i)


# seeds whose configs cover every family (their labels are checked)
TRI_SEEDS = {
    1007: "seed=1007 B=1 F=16 47x33 [zero-area,offscreen,near-plane,huge]",
    1016: "seed=1016 B=2 F=16 47x33 [near-plane,alpha1]",
    1022: "seed=1022 B=2 F=16 48x40 [zero-area,offscreen,huge]",
}
TET_SEEDS = {
    2012: "seed=2012 B=1 F=120 r=2.39 j=0.18 [alpha1,deep]",
    2015: "seed=2015 B=1 F=120 r=0.56 j=0.13 [cam-inside]",
}


@pytest.mark.parametrize("seed", list(TRI_SEEDS))
def test_tri_check_config_clean_on_cpu(seed):
    label, errs = ptri.check_config(seed, CPU)
    assert label == TRI_SEEDS[seed]
    assert errs == []


@pytest.fixture(scope="module")
def tet_specs():
    return {seed: ptet.spec_outputs(seed) for seed in TET_SEEDS}


@pytest.mark.parametrize("seed", list(TET_SEEDS))
def test_tet_check_config_clean_on_cpu(seed, tet_specs):
    """Both first hits (dense and binned) held to the f64 spec."""
    label, errs = ptet.check_config(seed, CPU, tet_specs[seed])
    assert label == TET_SEEDS[seed]
    assert errs == []


def test_tri_harness_reports_a_perturbed_binned_colour(monkeypatch):
    """The binned colour moved by 1e-3: the harness reports the forward,
    even after the spec's arbitration."""
    real = ptri.render_tri_binned

    def perturbed(*a, **k):
        c, d = real(*a, **k)
        return c + 1e-3, d

    monkeypatch.setattr(ptri, "render_tri_binned", perturbed)
    _label, errs = ptri.check_config(1016, CPU)
    assert len(errs) == 1 and errs[0].startswith("fwd color=1.00e-03"), errs


def test_tet_harness_reports_a_perturbed_colour(tet_specs):
    c, *rest = tet_specs[2012]
    _label, errs = ptet.check_config(2012, CPU, (c + 1e-3, *rest))
    assert [e.split(" color=")[0] for e in errs] == ["dense: fwd",
                                                     "binned: fwd"], errs


def test_tri_main_prints_each_config_and_the_total(capsys):
    assert ptri.main(["2", "1015", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("seed=1015 ") and out[0].endswith(": ok")
    assert out[1].startswith("seed=1016 ")
    assert out[-1].startswith("2/2 configs clean; launches K1 0, K2 0")


def test_big_needs_the_card():
    with pytest.raises(SystemExit):
        ptri.main(["1", "1000", "--device", "cpu", "--big"])


def test_missing_test_helpers_raise_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(fuzz_common, "TESTS_DIR", tmp_path)
    monkeypatch.delitem(sys.modules, "dmesh_fuzz_scenes", raising=False)
    with pytest.raises(FileNotFoundError, match="tests/scenes.py"):
        ptri.make_config(1000)
