"""The port's wire codec and aggregation against the JAX package's.

The codec (``repro_torch.fl.runtime.codec``) is a numpy-for-numpy copy of
the reference's: for every codec × sparse × index coding × error
feedback, on empty, zero, integer (TM weights), normal, ``-0.0`` and
longer-than-``<u2`` vectors, the frames are byte-identical, the decoded
vectors and the error-feedback residuals bit-identical, and the
validation messages the same.

``aggregate`` sums non-integer uploads (a lossy wire's ``q·scale``) in
row order, as XLA:CPU's one-hot product does for one cluster and for ten
clusters of 17 to 300 features up to 110 rows; the limits of that order
are pinned below (ROADMAP.md, queue C)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import clustering as jclustering
from repro.fl.runtime import codec as jcodec
from repro_torch.core import clustering
from repro_torch.fl.runtime import codec
from test_torch_gpu import one_torch_thread  # noqa: F401


def _vectors():
    rng = np.random.default_rng(0)
    neg_zero = np.zeros(40, np.float32)
    neg_zero[::3] = -0.0
    neg_zero[5] = 2.5
    return {
        "empty": np.zeros(0, np.float32),
        "zeros": np.zeros(300, np.float32),
        "tm_weights": rng.integers(0, 40, 300).astype(np.float32),
        "sparse_weights": np.where(rng.random(300) < 0.9, 0,
                                   rng.integers(1, 9, 300)).astype(np.float32),
        "normals": rng.standard_normal(301).astype(np.float32),
        "neg_zero": neg_zero,
        "long": np.where(rng.random(70_001) < 0.02,
                         rng.standard_normal(70_001), 0).astype(np.float32),
    }


VECTORS = _vectors()
WIRES = [dict(name=n, sparse=s, index_coding=ic, error_feedback=ef)
         for n in codec.CODECS for s in (False, True)
         for ic in (("u2", "vrle") if s else ("u2",))
         for ef in ((False, True) if n != "float32" else (False,))]


def _refs(vec):
    """None, all-zero and a nearby reference (most entries equal)."""
    rng = np.random.default_rng(1)
    near = vec.copy()
    if near.size:
        flip = rng.random(near.size) < 0.05
        near[flip] += rng.integers(-3, 4, int(flip.sum())).astype(np.float32)
    return {"none": None, "zeros": np.zeros_like(vec), "near": near}


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(
    str(v) for v in w.values()))
@pytest.mark.parametrize("name", VECTORS)
def test_frames_decodes_and_residuals_bit_identical(wire, name):
    vec = VECTORS[name]
    tcfg, jcfg = codec.CodecConfig(**wire), jcodec.CodecConfig(**wire)
    for ref_name, ref in _refs(vec).items():
        if ref is not None and not wire["sparse"]:
            continue
        what = f"{name} ref={ref_name}"
        if wire["error_feedback"]:
            residual = np.random.default_rng(2).standard_normal(
                vec.size).astype(np.float32) * 0.01
            tbuf, tres = codec.ef_encode(vec, tcfg, residual, ref=ref)
            jbuf, jres = jcodec.ef_encode(vec, jcfg, residual, ref=ref)
            np.testing.assert_array_equal(_bits(tres), _bits(jres), what)
        else:
            tbuf = codec.encode(vec, tcfg, ref=ref)
            jbuf = jcodec.encode(vec, jcfg, ref=ref)
        assert tbuf == jbuf, what
        tdec = codec.decode(tbuf, vec.size, tcfg, ref=ref)
        jdec = jcodec.decode(jbuf, vec.size, jcfg, ref=ref)
        assert tdec.dtype == jdec.dtype == np.float32
        np.testing.assert_array_equal(_bits(tdec), _bits(jdec), what)
        assert codec.roundtrip_tolerance(vec, tcfg) \
            == jcodec.roundtrip_tolerance(vec, jcfg)


def test_frame_kinds_are_exercised():
    """The cases above reach every frame: dense fallback (flag 0), ``<u2``
    sparse (1), varint+RLE (2), and the dense fallback forced by a
    vector longer than ``<u2`` addresses, which vrle still codes."""
    vec, near = VECTORS["tm_weights"], _refs(VECTORS["tm_weights"])["near"]
    flags = {ic: codec.encode(vec, codec.CodecConfig(
        "int8", sparse=True, index_coding=ic), ref=near)[0]
        for ic in ("u2", "vrle")}
    assert flags == {"u2": 1, "vrle": 2}
    assert codec.encode(vec, codec.CodecConfig("int8", sparse=True))[0] == 0
    long = VECTORS["long"]
    assert codec.encode(long, codec.CodecConfig("int4", sparse=True))[0] == 0
    assert codec.encode(long, codec.CodecConfig(
        "int4", sparse=True, index_coding="vrle"))[0] == 2


@pytest.mark.parametrize("kw", [
    dict(name="int16"), dict(index_coding="rle"),
    dict(index_coding="vrle"), dict(error_feedback=True)])
def test_validation_messages_equal(kw):
    with pytest.raises(ValueError) as ours:
        codec.CodecConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jcodec.CodecConfig(**kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("flag", [b"\x03", b"\xff"])
def test_unknown_frame_flags_refused_alike(flag):
    cfg = codec.CodecConfig("int8", sparse=True)
    with pytest.raises(ValueError) as ours:
        codec.decode(flag + bytes(8), 4, cfg)
    with pytest.raises(ValueError) as ref:
        jcodec.decode(flag + bytes(8), 4, jcodec.CodecConfig("int8",
                                                             sparse=True))
    assert str(ours.value) == str(ref.value)


# -- aggregation of non-integer uploads ------------------------------------

def _lossy_uploads(n, m, n_clusters, seed, one_cluster=False):
    """Decoded int8 rows: q·scale with q in [−127, 127], non-integers."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, m)).astype(np.float32)
    up = (q * np.float32(0.37)).astype(np.float32)
    ids = (np.zeros(n, np.int32) if one_cluster
           else rng.integers(-1, n_clusters, n).astype(np.int32))
    return up, ids


def _both(up, ids, n_clusters):
    ref = jclustering.aggregate(jnp.asarray(up), jnp.asarray(ids),
                                n_clusters)
    got = clustering.aggregate(torch.as_tensor(up), torch.as_tensor(ids),
                               n_clusters)
    return ref, got


@pytest.mark.parametrize("rows", [1, 20, 64, 100])
@pytest.mark.parametrize("n_clusters,m", [(10, 300), (1, 3000), (10, 24)])
@pytest.mark.parametrize("one_cluster", [False, True])
def test_aggregate_bit_identical_on_lossy_uploads(rows, n_clusters, m,
                                                  one_cluster):
    up, ids = _lossy_uploads(rows, m, n_clusters, rows, one_cluster)
    ref, got = _both(up, ids, n_clusters)
    np.testing.assert_array_equal(_bits(ref.cluster_weights),
                                  _bits(got.cluster_weights.numpy()))
    np.testing.assert_array_equal(np.asarray(ref.counts),
                                  got.counts.numpy())


def test_aggregate_order_limit_is_pinned():
    """Queue C: where XLA's dot does not add the rows one after another,
    a non-integer aggregate differs from the port's row order in the
    last place.  At ten clusters of 300 features the first row count
    that differs (all rows in one cluster) is 111; at 16 features XLA
    sums 12 rows in four lanes, ((r0+r4)+r8) + ... reduced pairwise."""
    for rows, same in ((110, True), (111, False)):
        up, ids = _lossy_uploads(rows, 300, 10, 7, one_cluster=True)
        ref, got = _both(up, ids, 10)
        equal = np.array_equal(_bits(ref.cluster_weights),
                               _bits(got.cluster_weights.numpy()))
        assert equal == same, rows
    up, ids = _lossy_uploads(12, 16, 10, 7, one_cluster=True)
    ref, got = _both(up, ids, 10)
    lanes = [up[j::4].astype(np.float32) for j in range(4)]
    lanes = [((a[0] + a[1]).astype(np.float32) + a[2]).astype(np.float32)
             for a in lanes]
    four = (((lanes[0] + lanes[1]).astype(np.float32)
             + (lanes[2] + lanes[3]).astype(np.float32)).astype(np.float32)
            / np.float32(12)).astype(np.float32)
    np.testing.assert_array_equal(_bits(ref.cluster_weights)[0], _bits(four))
    assert not np.array_equal(_bits(ref.cluster_weights),
                              _bits(got.cluster_weights.numpy()))


def test_aggregate_integer_uploads_exact_in_any_order():
    """The float32 wire's uploads are integers: every order is exact, so
    the port equals the reference at any shape (here 16 features, where
    XLA adds in four lanes, and 150 rows)."""
    rng = np.random.default_rng(3)
    for n, m in ((12, 16), (150, 300)):
        up = rng.integers(0, 64, size=(n, m)).astype(np.float32)
        ids = rng.integers(-1, 10, n).astype(np.int32)
        ref, got = _both(up, ids, 10)
        np.testing.assert_array_equal(_bits(ref.cluster_weights),
                                      _bits(got.cluster_weights.numpy()))
