"""Experiment tools of the port: the JAX package's TPU experiments asked
again of one CUDA card.

``exp_round3``: the round-3 battery (e1-e12) with the probe kernels T1
(``take_rows``), T2 (``roll_merge``) and T3 (``mega_step``);
``proto_march_kernel``: the fused march-step prototype T4
(``proto_step``) and its chain of steps. Both run as modules:

    python -m dmesh_renderer_tpu_torch.tools.exp_round3 [which...] [--device cpu]
    python -m dmesh_renderer_tpu_torch.tools.proto_march_kernel [--device cpu]

On ``cuda`` (the default) the kernels of ``csrc/probes.cu`` and
``csrc/march_probe.cu`` run; on ``cpu`` their plain torch versions.
"""
