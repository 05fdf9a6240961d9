"""The arithmetic of the rooflines: the least time the card could take for
a kernel's work at these inputs, from operations and bytes that the
benchmark counts itself (the plain reference's forward on each traced
step's views at that step's parameters: ``reference/tri.py`` and
``reference/tet.py`` fill ``counts``), never from the program's buffers,
capacities or layouts.

A bound is the larger of operations / 67 TFLOP/s (f32 outside the tensor
cores) and bytes / 3.35 TB/s (HBM3), the published peaks of one H100 SXM
at 700 W; the card's power limit is printed beside every run. Each input
byte is counted read once and each output byte written once. The
operation counts per unit of work are those the port's ``chip_smoke.py``
worked out for its kernels (a copy: the originals may change).
"""

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# tri: a (pixel, list position) visit tests coverage (3 edges x (2 mul +
# 2 add + 1 compare) + the nondegenerate test). The backward's blended
# visit: intersection 27, clamp 6, weights 2, T rebuild
# 3, interpolation 23, accumulators 16, dalpha and background 22, the
# weight and clamp chain 42, the moments 34; and its 20 values summed over
# the pixels (20 adds).
OPS_PER_VISIT = 16
OPS_PER_BWD_HIT = 175 + 20
# per face: 27 f32 (positions, colours, depths) and 9 int32 edge
# coefficients, read once; per (tile, face) list entry its face id
FACE_ROW_BYTES = (27 + 9) * 4
LIST_ENTRY_BYTES = 4
# per pixel the backward reads its ray (12), the forward's final
# transmittance and last contributor (12) and the upstream gradients (16)
BWD_PIXEL_BYTES = 12 + 12 + 16
# per face the backward writes its gradients: positions 9, colours 9,
# opacity 1, depths 3, intensity 1
FACE_GRAD_BYTES = 23 * 4

# tet backward march: per record (a blended face of an active ray) barycentric
# 2, colour 18, depth 9, log T 1, exp 1, the four suffix accumulators 16,
# dL/dalpha 12 and its background term 7, the weight 2, the nine colour
# moments 12, termination 2; per walk step back 4 slots x (the normal's dot
# 5, Moller-Trumbore 51, selection 5)
OPS_PER_BWD_VISIT = 82
OPS_PER_NRM_WALK = 4 * (5 + 51 + 5)
# per ray with records: ray 12, projective depth 16, start face, tet and
# first face 12, its 11 float rows 44, its record offset 8; per pixel its
# record count 4 and a flag 1; per record its key 4 and 10 values 40; per
# tet its 4 corners 48 and 4 face and 4 neighbour ids 32; per face its 3
# corner colours 36, opacity, log(1 - opacity) and intensity 12
K5_RAY_BYTES = 12 + 16 + 12 + 44 + 8
K5_PIXEL_BYTES = 4 + 1
K5_REC_BYTES = 4 + 10 * 4
TET_BYTES = 48 + 32
TET_FACE_BYTES = 36 + 12


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def k2(c: dict) -> float:
    """The tri backward composite's bound, seconds."""
    return bound_s(c["bwd_visits"] * OPS_PER_VISIT
                   + c["hits"] * OPS_PER_BWD_HIT,
                   c["pairs"] * LIST_ENTRY_BYTES + c["faces"] * FACE_ROW_BYTES
                   + c["pixels"] * BWD_PIXEL_BYTES
                   + c["faces"] * FACE_GRAD_BYTES)


def k5(c: dict) -> float:
    """The tet backward march's bound, seconds."""
    walks = c["records"] - c["rays"]
    return bound_s(c["records"] * OPS_PER_BWD_VISIT
                   + walks * OPS_PER_NRM_WALK,
                   c["pixels"] * K5_PIXEL_BYTES + c["rays"] * K5_RAY_BYTES
                   + c["records"] * K5_REC_BYTES + c["tets"] * TET_BYTES
                   + c["faces"] * TET_FACE_BYTES)


def share(run, kernel: str, bound) -> float | None:
    """100 x bound / the kernel's device time over the traced window, or
    None where the trace holds no such kernel."""
    import sys

    from harness.devtrace import kernel_seconds

    if run.trace_summary is None or run.counts is None:
        return None
    t = kernel_seconds(run.trace_summary, kernel)
    if not t:
        return None
    pct = 100.0 * bound(run.counts) / t
    print(f"portbench: {kernel} {t * 1e3:.4f} ms over {run.trace_units} "
          f"units, bound {bound(run.counts) * 1e3:.4f} ms: {pct:.2f}%",
          file=sys.stderr, flush=True)
    return pct
