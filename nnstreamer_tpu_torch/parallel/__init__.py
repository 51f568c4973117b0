"""Parallel and sequence-parallel building blocks.

Only what the serving paths use is ported so far: the single-device
attention (``ring_attention.local_attention``) and the StreamFormer config,
LayerNorm and parameter tree (``train_step``).  Ring/Ulysses attention,
the mesh and the train step wait for the training slice (ROADMAP A12).
"""
