"""The CUDA kernels of ceph_tpu_torch against their plain PyTorch
versions, on the card, byte for byte (integer math: no tolerance).

Marked ``gpu``: without a card every test skips. On a machine with one,
run ``python -m pytest --noconftest -m gpu tests/torch_gpu/`` (the
``--noconftest`` because the suite's conftest imports JAX, which the
port's machines need not have). Imports nothing of JAX or ceph_tpu.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain  # noqa: E402
from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks  # noqa: E402
from ceph_tpu_torch.gf import (  # noqa: E402
    decode_matrix,
    gf_matrix_to_bitmatrix,
    isa_cauchy_matrix,
    isa_rs_matrix,
)
from ceph_tpu_torch.ops import cuda_encode as ce  # noqa: E402
from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(shape, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("c,r", [(5, 3), (8, 4), (10, 4), (8, 1)])
@pytest.mark.parametrize("n", [1, 37, 4096, 65536 + 37])
def test_gf_apply_matches_plain(cuda, c, r, n):
    gen = isa_cauchy_matrix(c, r)
    bm = gf_matrix_to_bitmatrix(gen[c:])
    data = _data((3, c, n)).to(cuda)
    want = gf_encode_bitplane(bm, data)
    assert torch.equal(ce.gf_apply(bm, data), want)
    shards = [data[:, i].contiguous() for i in range(c)]
    for j, got in enumerate(ce.gf_apply_shards(bm, shards)):
        assert torch.equal(got, want[:, j])
    torch.cuda.synchronize()


def test_gf_apply_decode_matrix(cuda):
    gen = isa_rs_matrix(8, 4)
    present = [1, 2, 4, 5, 6, 7, 8, 10]
    bm = gf_matrix_to_bitmatrix(decode_matrix(gen, 8, present)[[0, 3]])
    data = _data((2, 8, 8192)).to(cuda)
    assert torch.equal(ce.gf_apply(bm, data), gf_encode_bitplane(bm, data))


@pytest.mark.parametrize("cb", [256, 1024, 4096, 65536])
@pytest.mark.parametrize("c,r", [(8, 4), (5, 3), (10, 4)])
def test_gf_apply_csum_matches_plain(cuda, c, r, cb):
    bm = gf_matrix_to_bitmatrix(isa_cauchy_matrix(c, r)[c:])
    data = _data((2, c, 2 * 65536)).to(cuda)
    want_p, want_c = ce.gf_apply_csum_plain(bm, data, cb)
    got_p, got_c = ce.gf_apply_csum(bm, data, cb)
    assert torch.equal(got_p, want_p) and torch.equal(got_c, want_c)
    shards = [data[:, i].contiguous() for i in range(c)]
    sp, sc = ce.gf_apply_csum_shards(bm, shards, cb)
    assert all(torch.equal(sp[j], want_p[:, j]) for j in range(r))
    assert torch.equal(sc, want_c)


@pytest.mark.parametrize("block", [1, 31, 512, 4096, 65536, 1000])
@pytest.mark.parametrize("init", [0, 0xFFFFFFFF, 0x1234ABCD])
def test_crc32c_blocks_matches_plain(cuda, block, init):
    data = _data((33, block)).to(cuda)
    assert torch.equal(
        crc32c_blocks(data, init), crc32c_fold_plain(data, init)
    )


def test_codec_routes_on_the_card(cuda):
    """CUDA tensors ride the kernels (kernel_*); ec_use_kernels off runs
    the plain forms on the card (plain_*); both give the same bytes."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters
    from ceph_tpu_torch.utils import config

    codec = registry.factory("isa", {"k": "8", "m": "4"}, device="cuda")
    data = {i: _data((2, 8192), seed=i).to(cuda) for i in range(8)}
    counters = dispatch_counters()
    results = {}
    for use in (True, False):
        counters.reset()
        with config.override(ec_use_kernels=use):
            par, csums = codec.encode_chunks_with_csums(data, 4096)
            dec = codec.decode_chunks(
                {0, 9}, {i: v for i, v in {**data, **par}.items()
                         if i not in (0, 9)})
        route = "kernel" if use else "plain"
        got = counters.dump()
        assert got[f"{route}_encode"] == 1 and got[f"{route}_decode"] == 1
        results[use] = (par, csums, dec)
    (pk, ck, dk), (pp, cp, dp) = results[True], results[False]
    assert all(torch.equal(pk[j], pp[j]) for j in pk)
    assert np.array_equal(ck, cp)
    assert torch.equal(dk[0], data[0]) and torch.equal(dp[9], pk[9])
