"""The fused march-step prototype (T4), asked of one CUDA card.

A port of the JAX package's ``tools/proto_march_kernel.py``: one kernel for
the whole tet march step (connectivity step, blend and state update) on
random tables, chained for ``REPS`` steps, where each step gathers the pack
row of the ray's tet ``ct`` and the shade row of its face ``cf`` inside
the kernel and the next step's ``cf``/``ct`` are the truncated f32 rows 3
and 10 of the output, modulo F and T.

The tables are uniform floats in [0, 1), ids included, as in the JAX tool
(``RandomState(0)``). So no slot face equals the ray's face: every lane
takes the error branch (four "other" faces), no lane advances, and rows 3
and 10 keep their values in [0, 1). From step 2 on every ray gathers row 0
of both tables. The tool times step 1 (random gathers) and the chain apart.
It does not subtract a dispatch constant.

Run: python -m dmesh_renderer_tpu_torch.tools.proto_march_kernel
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api import resolve_device
from ..kernels import launch
from ..ops.geometry import sat_i32
from ..ops.tet import _walk
from .exp_round3 import _on_cuda, _timer, _want, e5_inputs

M, T, F = 640_000, 48_000, 98_400
REPS = 8         # chained steps
PACK_COLS = 48   # tet geometry 40, face ids 4 and neighbour ids 4 as f32
SHADE_COLS = 12
ROWS = 16        # consts and state rows (T4 reads consts rows 0..9)


def random_tables(dev, M=M, T=T, F=F):
    """The JAX tool's random inputs (``RandomState(0)``, in its order) on
    ``dev``: pack [T, 48], shade [F, 12], ct [M], cf [M] int32, consts and
    state [16, M] f32."""
    rng = np.random.RandomState(0)
    arrs = (rng.rand(T, PACK_COLS).astype(np.float32),
            rng.rand(F, SHADE_COLS).astype(np.float32),
            rng.randint(0, T, M).astype(np.int32),
            rng.randint(0, F, M).astype(np.int32),
            rng.rand(ROWS, M).astype(np.float32),
            rng.rand(ROWS, M).astype(np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


def mesh_tables(dev, n_grid=20, M=M):
    """T4's inputs on a real mesh, where walks are valid and rays advance
    (the tool's random tables never advance a ray): e5's tables and rays
    (``exp_round3.e5_inputs``) with the pack the mega row's first 48
    columns; the state holds the ray's face (row 3) and tet (row 10), log T
    0 and T 1, the rest 0; consts rows 10..15, which T4 does not read, are
    ``RandomState(3)`` draws. The same tuple as ``random_tables``."""
    march, mega, ct, consts, st3 = e5_inputs(dev, n_grid, M)
    state = torch.zeros((ROWS, M), device=dev)
    state[3] = st3[3]
    state[5] = 1.0
    state[10] = ct.to(torch.float32)
    extra = np.random.RandomState(3).rand(ROWS - 10, M).astype(np.float32)
    return (mega[:, :PACK_COLS].contiguous(), march["shade"], ct,
            st3[3].to(torch.int32),
            torch.cat([consts, torch.from_numpy(extra).to(dev)]), state)


def proto_step(pack, shade, ct, cf, consts, state):
    """T4: one fused march step per ray. pack [T, 48] f32 gathered by ct
    [M] int32, shade [F, 12] f32 by cf [M] int32 (both clamped), consts
    [16, M] f32 (rows 0..9: origin, direction, projective z/w), state
    [16, M] f32 (t, u, v, face, log T, T, C rgb, D, tet, ...). Returns the
    next state [16, M] f32.

    On CUDA tensors this launches the kernel of csrc/march_probe.cu (and
    raises if it cannot); on CPU tensors it runs ``proto_step_plain``."""
    nT, nF, nM = pack.shape[0], shade.shape[0], ct.shape[0]
    _want("proto_step", pack, torch.float32, (nT, PACK_COLS))
    _want("proto_step", shade, torch.float32, (nF, SHADE_COLS))
    _want("proto_step", ct, torch.int32, (nM,))
    _want("proto_step", cf, torch.int32, (nM,))
    _want("proto_step", consts, torch.float32, (ROWS, nM))
    _want("proto_step", state, torch.float32, (ROWS, nM))
    args = (pack, shade, ct, cf, consts, state)
    if not _on_cuda("proto_step", *args):
        return proto_step_plain(*args)
    ins = [x.contiguous() for x in args]
    for k in (0, 1):  # the kernel reads the table rows as float4
        if ins[k].data_ptr() % 16:
            ins[k] = ins[k].clone()
    out = torch.empty_like(ins[5])
    launch("march_probe", "proto_step", ins + [out], [nM, nT, nF],
           pack.device)
    proto_step.launches += 1
    return out


proto_step.launches = 0


def proto_step_plain(pack, shade, ct, cf, consts, state):
    """Plain torch version of ``proto_step``: the same f32 ops in the same
    order, vectorised over the rays."""
    p = pack[ct.long().clamp(0, pack.shape[0] - 1)]
    sh = shade[cf.long().clamp(0, shade.shape[0] - 1)]
    s, c = state, consts
    t0, u0, v0, cur = s[0], s[1], s[2], s[3]
    err, nface, ntet, nt_, nu_, nv_ = _walk(
        p[:, :40], p[:, 40:], cur, [c[0], c[1], c[2]], [c[3], c[4], c[5]])
    alpha, l1a, inten = sh[:, 9], sh[:, 10], sh[:, 11]
    w = s[5] * alpha
    rgb = [(sh[:, ch] + (sh[:, 3 + ch] - sh[:, ch]) * u0
            + (sh[:, 6 + ch] - sh[:, ch]) * v0) * inten for ch in range(3)]
    dep = (c[6] + t0 * c[8]) / (c[7] + t0 * c[9] + 1e-4)
    log_t = s[4] + l1a
    tc2 = torch.exp(log_t)
    adv = ~err & (tc2 > 1e-4)
    return torch.stack([
        torch.where(adv, nt_, t0), torch.where(adv, nu_, u0),
        torch.where(adv, nv_, v0), torch.where(adv, nface, cur), log_t, tc2,
        s[6] + rgb[0] * w, s[7] + rgb[1] * w, s[8] + rgb[2] * w,
        s[9] + dep * w, torch.where(adv, ntet, s[10]), err.to(torch.float32),
        s[12] + 1.0, s[13], s[14], s[15]])


def chain(pack, shade, ct, cf, consts, state, steps=REPS, step=proto_step):
    """``steps`` chained steps: after each, cf = trunc(out[3]) % F and
    ct = trunc(out[10]) % T (saturating truncation, floor modulo). Returns
    (state, cf, ct) after the last step."""
    nT, nF = pack.shape[0], shade.shape[0]
    for _ in range(steps):
        state = step(pack, shade, ct, cf, consts, state)
        cf = torch.remainder(sat_i32(state[3]), nF).to(torch.int32)
        ct = torch.remainder(sat_i32(state[10]), nT).to(torch.int32)
    return state, cf, ct


def main(argv=None):
    """Time step 1 and the chain of REPS steps on ``--device`` (cuda by
    default). Returns the times (ms) and the rays' distinct faces and tets
    after step 1."""
    ap = argparse.ArgumentParser(
        prog="python -m dmesh_renderer_tpu_torch.tools.proto_march_kernel",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev)


def run(dev, **sizes):
    """The tool's measurement on ``dev`` at ``random_tables(dev, **sizes)``."""
    tabs = random_tables(dev, **sizes)
    measure = _timer(dev)
    step1_ms = measure(lambda: proto_step(*tabs))
    chain_ms = measure(lambda: chain(*tabs))
    _s, cf, ct = chain(*tabs, steps=1)
    res = {"step1_ms": step1_ms, "chain_ms": chain_ms,
           "chain_ms_per_step": chain_ms / REPS,
           "distinct_cf_after_step1": int(torch.unique(cf).numel()),
           "distinct_ct_after_step1": int(torch.unique(ct).numel())}
    print(f"step 1 (random gathers): {step1_ms:.4f} ms", flush=True)
    print(f"total {chain_ms:.4f} ms for {REPS} steps -> "
          f"{chain_ms / REPS:.4f} ms/step; after step 1 the rays hold "
          f"{res['distinct_cf_after_step1']} distinct faces and "
          f"{res['distinct_ct_after_step1']} distinct tets", flush=True)
    return res


if __name__ == "__main__":
    main()
