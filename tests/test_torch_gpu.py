"""The hand-written mmchain kernel (systemml_tpu_torch/codegen/csrc/
mmchain.cu) on the card, against its plain version.

Marked `gpu`: without a CUDA card every test skips, with the reason,
from the `cuda` fixture (decided at run time, never at import, so every
test worker collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -q

Bar: normwise relative error <= 1e-5 against the plain version run in
fp64 on the card from the same fp32 inputs (fp32 sums over 1,037 rows in
another order), and bit-identical output from two launches.
"""

import numpy as np
import pytest
import torch

from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.ops import mult

pytestmark = pytest.mark.gpu

M, K = 1037, 128
CASES = [("XtXv", 1, 0), ("XtXv", 4, 0),
         ("XtwXv", 1, 1), ("XtwXv", 4, 1), ("XtwXv", 4, 4),
         ("XtXvy", 1, 1), ("XtXvy", 4, 1), ("XtXvy", 4, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(dev, c, wc, k=K, m=M, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((k, c)).astype(np.float32))
    w = (torch.from_numpy(rng.standard_normal((m, wc)).astype(np.float32))
         if wc else None)
    return x.to(dev), v.to(dev), None if w is None else w.to(dev)


def _check(x, v, w, ctype):
    before = kernels.mmchain_kernel.launches
    out = kernels.mmchain_kernel(x, v, w, ctype)
    again = kernels.mmchain_kernel(x, v, w, ctype)
    torch.cuda.synchronize()
    assert kernels.mmchain_kernel.launches == before + 2
    assert torch.equal(out, again)
    ref = kernels.mmchain_plain(x.double(), v.double(),
                                None if w is None else w.double(), ctype)
    err = (torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))
    assert out.shape == ref.shape and float(err) <= 1e-5


@pytest.mark.parametrize("ctype,c,wc", CASES)
def test_kernel_matches_plain(cuda, ctype, c, wc):
    _check(*_inputs(cuda, c, wc), ctype)


@pytest.mark.parametrize("k", [128, 130, 1000, 2048])
def test_kernel_widths_and_unaligned_k(cuda, k):
    _check(*_inputs(cuda, 8, 8, k=k, m=777), "XtXvy")


def test_dispatch_takes_kernel_by_shape(cuda):
    x, v, _ = _inputs(cuda, 1, 0)
    before = kernels.mmchain_kernel.launches
    mult.mmchain(x, v)
    assert kernels.mmchain_kernel.launches == before + 1
    mult.mmchain(x[:, :100].contiguous(), v[:100])   # k < 128: two-pass
    mult.mmchain(x.double(), v.double())             # fp64: two-pass
    assert kernels.mmchain_kernel.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, v, _ = _inputs(cuda, 1, 0)
    with pytest.raises(TypeError):
        kernels.mmchain_kernel(x.double(), v.double())
    with pytest.raises(ValueError):
        kernels.mmchain_kernel(x.T.contiguous().T, v)
    with pytest.raises(ValueError):
        kernels.mmchain_kernel(x[:, :100].contiguous(), v[:100])


@pytest.mark.parametrize("width,rows,cols", [
    (260, slice(5, None), slice(0, 200)),    # 16-byte loads
    (260, slice(0, None), slice(1, 131)),    # misaligned start
    (260, slice(3, None), slice(3, 259)),    # misaligned, k % 4 == 0
    (258, slice(0, None), slice(0, 128)),    # row stride % 4 != 0
])
def test_kernel_reads_slices_in_place(cuda, width, rows, cols):
    x, v, w = _inputs(cuda, 4, 1, k=width, m=901)
    xs = x[rows, cols]
    assert not xs.is_contiguous()
    _check(xs, v[:xs.shape[1]], w[rows], "XtwXv")


def test_dispatch_launches_on_views(cuda):
    x, v, _ = _inputs(cuda, 1, 0, k=300)
    b, _, _ = _inputs(cuda, 1, 0, k=M, m=K, seed=4)
    before = kernels.mmchain_kernel.launches
    for xs in (x[:, :200], x[10:, 50:250], b.T):   # X[, a:b], t(B)
        vs = v[:xs.shape[1]]
        out = mult.mmchain(xs, vs)
        ref = kernels.mmchain_plain(xs.double(), vs.double())
        err = torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)
        assert float(err) <= 1e-5
    assert kernels.mmchain_kernel.launches == before + 3
