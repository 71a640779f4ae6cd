"""The split-K plans that the whole decode's step products take from Python
(``ops/full_decode.py`` ``gemm_plan``). ``csrc/full_decode.cu`` follows a
plan as given: the grid is (N / BN, ceil(M / 64), splits) and part z of K
is [z * K / splits, (z + 1) * K / splits). These checks on the CPU hold
what the card then runs: every (tile, split) covers K exactly once, and
every product fills the card at every serving bucket.
"""
import pytest

from tps_pp_tpu_torch.ops.full_decode import (GEMM_BM, MAX_SPLITS,
                                              MIN_BLOCKS, gemm_plan,
                                              step_products)

# the flagship decoder's widths (d_model, heads x d_k, d_inner)
FLAGSHIP = dict(D=512, HD=512, DI=2048, H=8)
BUCKETS = [2 ** i for i in range(10)]          # pow2 serving buckets 1..512
PRODUCTS = [name for name, _, _ in step_products(FLAGSHIP)]


@pytest.mark.parametrize('product', PRODUCTS)
@pytest.mark.parametrize('N', BUCKETS)
def test_split_k_plan_covers_k_and_fills_the_card(N, product):
    _, n_out, K = next(p for p in step_products(FLAGSHIP) if p[0] == product)
    bn, splits = gemm_plan(N, n_out, K)
    assert n_out % bn == 0
    # the parts of a tile are one cluster of blocks
    assert 1 <= splits <= MAX_SPLITS
    # the kernel's parts: each a run of whole 16-deep steps, together
    # covering [0, K) exactly once, in order
    parts = [(z * K // splits, (z + 1) * K // splits) for z in range(splits)]
    assert parts[0][0] == 0 and parts[-1][1] == K
    assert all(a < b and (b - a) % 16 == 0 for a, b in parts)
    assert all(parts[i][1] == parts[i + 1][0] for i in range(splits - 1))
    # every (tile, split) once, on at least as many blocks as the card has
    # SMs
    blocks = (n_out // bn) * -(-N // GEMM_BM) * splits
    assert blocks >= MIN_BLOCKS, (product, N, bn, splits)


def test_split_k_plan_refuses_widths_it_cannot_tile():
    with pytest.raises(ValueError, match='gemm_plan'):
        gemm_plan(64, 24, 512)
