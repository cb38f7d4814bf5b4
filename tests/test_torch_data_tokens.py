"""The port's token data layer (``determined_tpu_torch.data``) against the
reference's (``determined_tpu.data``), on the CPU.

- The port's ``TokenDataset`` streams equal the reference's bit for bit,
  over seeds × ``token_bytes`` 2/4 × shuffle, through the port's native
  loader and its python one (the reference's python stream is the
  yardstick: the reference holds its own native stream equal to it).
- ``skip(n)`` then next equals the n-th batch, natively and in python.
- ``lm_dataset``'s shard and synthetic streams equal the reference's.
- The zigzag layout: ``tests/test_torch_ring.py``.
- The native library is built under ``determined_tpu_torch/_build/``,
  not the reference's ``native/_build/``.
All comparisons are exact (integer tokens).
"""
from pathlib import Path

import numpy as np
import pytest

from determined_tpu.data import tokens as jtokens
from determined_tpu_torch.data import native as tnative
from determined_tpu_torch.data import tokens as ttokens

ROOT = Path(__file__).resolve().parent.parent
B, S = 4, 32


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two shards per token width (uint16 and int32) of seeded tokens."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    out = {}
    for token_bytes, vocab in ((2, 50257), (4, 1 << 20)):
        paths = []
        for i, n in enumerate((3000, 1777)):
            path = str(d / f"w{token_bytes}-{i}.bin")
            ttokens.write_token_shard(path, rng.integers(0, vocab, n),
                                      token_bytes=token_bytes)
            paths.append(path)
        out[token_bytes] = paths
    return out


def _take(ds, n):
    return [next(ds)["tokens"] for _ in range(n)]


def test_library_is_built_under_the_ports_build_dir():
    lib = tnative.load_library()
    assert lib is not None, "g++ is on this box: the native loader must build"
    so = tnative.library_path()
    assert so.exists()
    assert so.parent == ROOT / "determined_tpu_torch" / "_build"
    assert tnative.SRC == ROOT / "native" / "dataloader.cpp"


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "seq"])
@pytest.mark.parametrize("token_bytes", [2, 4])
@pytest.mark.parametrize("seed", [0, 11])
def test_stream_equals_the_references(shards, seed, token_bytes, shuffle,
                                      use_native):
    kw = dict(token_bytes=token_bytes, seed=seed, shuffle=shuffle)
    port = ttokens.TokenDataset(shards[token_bytes], B, S,
                                use_native=use_native, **kw)
    ref = jtokens.TokenDataset(shards[token_bytes], B, S, use_native=False,
                               **kw)
    try:
        assert port.native is use_native
        assert port.total_tokens == ref.total_tokens == 4777
        for got, want in zip(_take(port, 12), _take(ref, 12)):
            assert got.dtype == np.int32 and got.shape == (B, S)
            np.testing.assert_array_equal(got, want)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_skip_then_next_is_the_nth_batch(shards, use_native):
    full = ttokens.TokenDataset(shards[2], B, S, seed=5, use_native=use_native)
    want = _take(full, 40)
    full.close()
    for n in (0, 1, 7, 33):
        ds = ttokens.TokenDataset(shards[2], B, S, seed=5,
                                  use_native=use_native)
        _take(ds, 2)
        ds.skip(n)
        assert ds.batches_consumed == 2 + n
        np.testing.assert_array_equal(next(ds)["tokens"], want[2 + n])
        ds.close()


def test_lm_dataset_streams_equal_the_references(shards, tmp_path):
    # synthetic (no shards)
    port = ttokens.lm_dataset(None, B, S, vocab_size=1000, seed=3)
    ref = jtokens.lm_dataset(None, B, S, vocab_size=1000, seed=3)
    for got, want in zip(_take(port, 5), _take(ref, 5)):
        np.testing.assert_array_equal(got, want)
    # over glob-expanded shard patterns
    pattern = [str(Path(shards[2][0]).parent / "w2-*.bin")]
    assert ttokens.expand_shards(pattern) == jtokens.expand_shards(pattern)
    port = ttokens.lm_dataset(pattern, B, S, vocab_size=50257, seed=2)
    ref = jtokens.lm_dataset(pattern, B, S, vocab_size=50257, seed=2)
    assert port.native
    for got, want in zip(_take(port, 6), _take(ref, 6)):
        np.testing.assert_array_equal(got, want)
    port.close()
    ref.close()


def test_shard_files_are_the_references_bytes(tmp_path):
    tokens = np.random.default_rng(4).integers(0, 60000, 999)
    for token_bytes in (2, 4):
        ttokens.write_token_shard(str(tmp_path / "p.bin"), tokens, token_bytes)
        jtokens.write_token_shard(str(tmp_path / "j.bin"), tokens, token_bytes)
        assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    with pytest.raises(ValueError, match="uint16"):
        ttokens.write_token_shard(str(tmp_path / "x.bin"),
                                  np.array([1 << 16]), 2)


def test_too_few_tokens_raises(tmp_path):
    path = str(tmp_path / "tiny.bin")
    ttokens.write_token_shard(path, np.arange(10))
    for use_native in (True, False):
        with pytest.raises(ValueError):
            ttokens.TokenDataset([path], 1, 32, use_native=use_native)
