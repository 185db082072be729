"""Parallel execution. Of systemml_tpu/parallel/ only the single-device
attention of ring.py is ported; the mesh, the collectives and the
sequence-parallel attention wait for ROADMAP queue 1, distributed and
elastic (item 12)."""
