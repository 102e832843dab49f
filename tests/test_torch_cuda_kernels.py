"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The module imports neither JAX nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-4 (the same math in another order); bfloat16 2e-2
(the plain versions round the attention weights to bf16 before the PV
product, the kernels keep them in float32).
"""

import pytest
import torch

from rocket_tpu_torch.ops import decode_attention as tda
from rocket_tpu_torch.ops import paged_attention as tpa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen).to(dtype).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,h_kv,d", [(12, 12, 64), (12, 4, 64), (6, 2, 128), (4, 4, 40)])
def test_paged_decode_matches_plain(cuda, hq, h_kv, d, dtype):
    gen = torch.Generator().manual_seed(hq * 100 + h_kv + d)
    s, mb, bl = 5, 9, 16
    nb = 1 + s * mb
    positions = torch.tensor([0, 15, 16, 100, mb * bl - 1], dtype=torch.int32)
    table = torch.zeros((s, mb), dtype=torch.int32)
    for i, p in enumerate(positions.tolist()):
        live = p // bl + 1
        table[i, :live] = 1 + i * mb + torch.randperm(mb, generator=gen)[:live].to(torch.int32)
    q = _randn(gen, dtype, s, hq, d)
    kp, vp = _randn(gen, dtype, nb, bl, h_kv, d), _randn(gen, dtype, nb, bl, h_kv, d)
    args = (q, kp, vp, table.cuda(), positions.cuda())
    before = tpa.paged_decode.launches
    got = tpa.paged_decode(*args)
    assert tpa.paged_decode.launches == before + 1
    torch.testing.assert_close(got.float(), tpa.paged_decode_plain(*args).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_paged_decode_rejects_bad_operands(cuda):
    q = torch.zeros(2, 4, 64, device=cuda)
    pages = torch.zeros(3, 16, 4, 64, device=cuda)
    table = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tpa.paged_decode(q.half(), pages.half(), pages.half(), table, pos)
    with pytest.raises(ValueError):
        tpa.paged_decode(q, pages, pages, table.long(), pos)
    with pytest.raises(ValueError):
        tpa.paged_decode(q.transpose(0, 1).contiguous().transpose(0, 1), pages, pages, table, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,h_kv,d", [(12, 12, 64), (12, 4, 64), (8, 2, 256)])
def test_decode_attention_matches_plain(cuda, hq, h_kv, d, dtype):
    gen = torch.Generator().manual_seed(hq + h_kv + d)
    b, t_max = 3, 200
    ops = [_randn(gen, dtype, *shape) for shape in
           [(b, hq, d), (b, h_kv, d), (b, h_kv, d), (b, h_kv, t_max, d), (b, h_kv, t_max, d)]]
    twin = [t.clone() for t in ops]
    for pos in (0, 63, t_max - 1):
        got = tda.decode_attention(*ops, pos)
        want = tda.decode_attention_plain(*twin, pos)
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
