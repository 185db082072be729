"""systemml_tpu_torch: the PyTorch/CUDA port of systemml_tpu for an NVIDIA
H100.

The same DML front end, HOP compiler and runtime as the JAX package
(`systemml_tpu/`), over torch tensors on an explicit device, with the
TPU's Pallas kernels rewritten by hand for Hopper (codegen/csrc/). The
port imports neither jax nor the JAX package; the tests are where the two
meet. Entry point: `systemml_tpu_torch.api.mlcontext.MLContext`, which
runs on the card unless its config says `device="cpu"`.
"""
