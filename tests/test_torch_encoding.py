"""The port's compressed snapshot columns against the JAX package's.

The codec, chooser, predicate, snapshot, star and tiered cases of
``tests/test_encoding.py`` (not its wire and cluster cases, which wait for
ROADMAP A.9) run through both packages on the CPU; the tiered ones read
roots that each package wrote, in both packages, and ``encode/exec.py``'s
helpers are held against the JAX package's. Codecs: the
port's ``encode_array`` / ``encode_chunk`` give the JAX package's payload
bytes and header for every array and codec, and decode bit for bit.
Snapshots: both packages, each over its own persist root, answer the same
statements (``tests/test_torch_sql.py``'s comparison: dimensions,
integers and counts exact, float sums rtol 1e-6) and hold the same store
column by column after each recovery; compression never changes an answer.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import os
import shutil
import threading

import numpy as np
import pytest

from spark_druid_olap_tpu.encode import chooser as JCH
from spark_druid_olap_tpu.encode import codecs as JC

from spark_druid_olap_tpu_torch.encode import chooser as CH
from spark_druid_olap_tpu_torch.encode import codecs as C
from spark_druid_olap_tpu_torch.encode import predicates as P
from spark_druid_olap_tpu_torch.persist import snapshot as SNAP

from conftest import make_sales_df
from test_torch_append import assert_same_store
from test_torch_persist import Pair, open_ctx

PKGS = ("jax", "port")
from test_torch_sql import assert_answers_equal

# -- codec round-trips --------------------------------------------------------

_R = np.random.default_rng(13)

ARRAYS = {
    "all_equal_i64": np.full(5000, 42, np.int64),
    "low_card_i8": _R.integers(0, 4, 5000).astype(np.int8),
    "narrow_i32": _R.integers(-50, 50, 3000).astype(np.int32),
    "sorted_i16": np.sort(_R.integers(0, 300, 4000)).astype(np.int16),
    "monotone_days_i32": np.sort(
        _R.integers(16000, 16400, 4000)).astype(np.int32),
    "adversarial_card_i64": _R.integers(
        np.iinfo(np.int64).min // 2, np.iinfo(np.int64).max // 2, 2000),
    "alternating_u16": np.tile(
        np.array([0, 65535], np.uint16), 1500),
    "bools": _R.integers(0, 2, 4096).astype(bool),
    "single": np.array([-7], np.int64),
    "negative_runs_i64": np.repeat(
        np.array([-3, -3000000000, 9], np.int64), 700),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("codec", [C.RAW, C.BITPACK, C.RLE, C.FORDELTA])
def test_codec_roundtrip_bit_exact(name, codec):
    arr = ARRAYS[name]
    payload, header = C.encode_array(arr, codec)
    jpayload, jheader = JC.encode_array(arr, codec)
    assert payload == jpayload and header == jheader
    out = C.decode_array(payload, header)
    assert out.dtype == arr.dtype
    np.testing.assert_array_equal(out, arr)
    assert out.flags.writeable
    assert C.decoded_nbytes(header) == arr.nbytes
    hb = C.header_bounds(header)
    if hb is not None:
        assert hb == (int(np.asarray(arr, np.int64).min()),
                      int(np.asarray(arr, np.int64).max()))


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("codec", C.CODECS)
def test_encode_chunk_same_bytes_in_both_packages(name, codec):
    """``encode_chunk`` (the snapshot writer's per-segment call, raw
    fallback included) gives the same bytes and header in both packages,
    and each decodes the other's payload."""
    arr = ARRAYS[name]
    payload, header = C.encode_chunk(arr, codec)
    jpayload, jheader = JC.encode_chunk(arr, codec)
    assert payload == jpayload and header == jheader
    np.testing.assert_array_equal(C.decode_array(jpayload, jheader), arr)
    np.testing.assert_array_equal(JC.decode_array(payload, header), arr)


@pytest.mark.parametrize("codec", C.CODECS)
@pytest.mark.parametrize("dt", ["i1", "i4", "i8", "u2", "b1"])
def test_codec_empty_roundtrip(codec, dt):
    arr = np.empty(0, np.dtype(dt))
    payload, header = C.encode_array(arr, codec)
    assert (payload, header) == JC.encode_array(arr, codec)
    out = C.decode_array(payload, header)
    assert out.dtype == arr.dtype and len(out) == 0
    assert C.header_bounds(header) is None


def test_encode_chunk_falls_back_to_raw_when_not_smaller():
    arr = ARRAYS["adversarial_card_i64"]
    payload, header = C.encode_chunk(arr, C.RLE)
    assert header["c"] == C.RAW
    assert len(payload) == arr.nbytes
    np.testing.assert_array_equal(C.decode_array(payload, header), arr)


def test_rle_runs_aggregates_without_expansion():
    arr = np.repeat(np.array([7, -2, 7, 0], np.int32), [10, 1, 25, 3])
    payload, header = C.encode_array(arr, C.RLE)
    values, lengths = C.rle_runs(payload, header)
    jvalues, jlengths = JC.rle_runs(payload, header)
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(values, [7, -2, 7, 0])
    np.testing.assert_array_equal(lengths, [10, 1, 25, 3])
    assert int((values.astype(np.int64) * lengths).sum()) == int(arr.sum())
    assert int(lengths.sum()) == len(arr)


def test_malformed_payloads_raise_encoding_error():
    arr = np.arange(100, dtype=np.int64)
    payload, header = C.encode_array(arr, C.BITPACK)
    with pytest.raises(C.EncodingError):
        C.decode_array(payload[: len(payload) // 2], header)
    rp, rh = C.encode_array(np.repeat(arr, 3), C.RLE)
    with pytest.raises(C.EncodingError):
        C.decode_array(rp, dict(rh, n=rh["n"] + 1))
    with pytest.raises(C.EncodingError):
        C.encode_array(arr, "lz77")
    with pytest.raises(C.EncodingError):
        C.encode_array(arr.reshape(10, 10), C.BITPACK)
    with pytest.raises(C.EncodingError):
        C.decode_array(b"", {"c": "nope", "n": 0, "dt": "<i8"})


def test_uint64_beyond_int64_refused_loudly():
    arr = np.array([0, np.iinfo(np.uint64).max], np.uint64)
    with pytest.raises(C.EncodingError):
        C.encode_array(arr, C.BITPACK)


def test_estimate_sizes_shapes():
    for name, arr in ARRAYS.items():
        assert C.estimate_sizes(arr) == JC.estimate_sizes(arr), name
    est = C.estimate_sizes(ARRAYS["monotone_days_i32"])
    assert C.FORDELTA in est and C.BITPACK in est and C.RLE in est
    assert C.FORDELTA not in C.estimate_sizes(ARRAYS["alternating_u16"])
    assert C.estimate_sizes(np.random.default_rng(0).uniform(
        size=100)) == {}
    assert C.estimate_sizes(np.empty(0, np.int64)) == {}


# -- chooser ------------------------------------------------------------------

def test_chooser_picks_and_declines():
    """The port's chooser, with the JAX package's default thresholds as
    constants, picks what the JAX chooser picks at those defaults."""
    on = JCH.EncodeOptions(enabled=True)
    low_card = _R.integers(0, 3, 8000).astype(np.int32)
    assert CH.choose_codec(low_card) in (C.BITPACK, C.RLE)
    assert CH.choose_codec(_R.uniform(size=1000)) is None
    assert CH.choose_codec(ARRAYS["adversarial_card_i64"]) is None
    assert CH.choose_codec(np.sort(low_card)) == C.RLE
    for name, arr in list(ARRAYS.items()) + [("low", low_card)]:
        assert CH.choose_codec(arr) == JCH.choose_codec(arr, on), name


def test_chooser_options_from_config(tmp_path):
    """The thresholds equal the JAX package's defaults, and the persist
    manager encodes exactly when ``sdot.encode.enabled`` is set."""
    assert (CH.MIN_RATIO, CH.RLE_MAX_RUN_FRAC) == (
        JCH.EncodeOptions().min_ratio, JCH.EncodeOptions().rle_max_run_frac)
    for enabled in (False, True):
        ctx = open_ctx("port", tmp_path / str(enabled),
                       **{"sdot.encode.enabled": enabled})
        assert ctx.persist.encode is enabled
        ctx.close()
    ctx = open_ctx("port", tmp_path / "default")
    assert ctx.persist.encode is False
    ctx.close()


# -- dictionary-predicate rewrite equivalence ---------------------------------

@pytest.fixture(scope="module")
def sales_dim():
    from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
    ds = ingest_dataframe("sales", make_sales_df(4000), time_column="ts",
                          target_rows=1024)
    return ds.dims["product"], ds


def _string_eval(dictionary, codes, pred):
    return np.array([pred(dictionary[c]) for c in codes])


def test_predicate_rewrite_matches_string_eval(sales_dim):
    import re
    dim, ds = sales_dim
    dictionary = dim.dictionary
    codes = dim.codes
    code = P.selector_code(dim, "p007")
    np.testing.assert_array_equal(
        codes == code, _string_eval(dictionary, codes, lambda s: s == "p007"))
    assert P.selector_code(dim, "zzz-absent") == -1
    for lo, hi, ls, us in [("p010", "p020", False, False),
                           ("p010", "p020", True, True),
                           (None, "p005", False, False),
                           ("p045", None, True, False)]:
        clo, chi = P.bound_code_range(dim, lo, hi, ls, us)
        got = (codes >= clo) & (codes < chi)

        def oracle(s, lo=lo, hi=hi, ls=ls, us=us):
            ok = True
            if lo is not None:
                ok = ok and (s > lo if ls else s >= lo)
            if hi is not None:
                ok = ok and (s < hi if us else s <= hi)
            return ok
        np.testing.assert_array_equal(
            got, _string_eval(dictionary, codes, oracle))
    mask = P.in_code_mask(dictionary, ["p001", "p030", "nope"])
    in_got = mask[codes]
    np.testing.assert_array_equal(in_got, _string_eval(
        dictionary, codes, lambda s: s in ("p001", "p030", "nope")))
    like = P.pattern_code_mask(dictionary, "like", "p00%")[codes]
    np.testing.assert_array_equal(like, _string_eval(
        dictionary, codes, lambda s: s.startswith("p00")))
    np.testing.assert_array_equal(
        P.pattern_code_mask(dictionary, "contains", "03")[codes],
        _string_eval(dictionary, codes, lambda s: "03" in s))
    np.testing.assert_array_equal(
        P.pattern_code_mask(dictionary, "regex", r"p0[12]")[codes],
        _string_eval(dictionary, codes,
                     lambda s: re.search(r"p0[12]", s) is not None))
    lo_c, hi_c = P.code_mask_bounds(mask)
    assert np.flatnonzero(mask).min() == lo_c
    assert np.flatnonzero(mask).max() == hi_c - 1
    assert P.code_mask_bounds(np.zeros(8, bool)) == (0, 0)


# -- snapshot format ----------------------------------------------------------

QUERIES = [
    "select region, sum(price) as rev, sum(qty) as q, count(*) as n "
    "from sales group by region order by region",
    "select product, sum(price) as rev from sales where status = 'O' "
    "group by product order by rev desc limit 7",
    "select flag, count(*) as n from sales where qty >= 25 "
    "group by flag order by flag",
    "select year(ts) as y, count(*) as n from sales "
    "group by year(ts) order by y",
    "select approx_count_distinct(product) as np from sales",
]

ENC = {"sdot.encode.enabled": True}


def _answers(p):
    return {q: p.sql(q) for q in QUERIES}


def _check(p, want):
    for q in QUERIES:
        assert_answers_equal(p.sql(q), want[q], True)
    p.same_store()


def _manifest(ctx, name="sales"):
    ds_root = ctx.persist._ds_root(name)
    return SNAP.load_manifest(ds_root, SNAP.current_version(ds_root))


def test_encoded_snapshot_roundtrip_and_ratio(tmp_path):
    p = Pair(tmp_path, **ENC)
    p.each(lambda c: c.ingest_dataframe("sales", make_sales_df(),
                                        time_column="ts", target_rows=4096))
    want = _answers(p)
    p.each(lambda c: c.checkpoint("sales"))
    man = _manifest(p.t)
    p.close()
    enc = man.get("encoding")
    assert enc is not None and enc["version"] == C.ENCODING_VERSION
    assert enc["columns"]
    assert all(c in C.CODECS for c in enc["columns"].values())
    assert enc["raw_bytes"] / max(enc["encoded_bytes"], 1) >= 2.0
    rel = next(iter(enc["columns"]))
    segs = man["files"][rel]["enc"]["segments"]
    assert all(len(s) == 3 and s[2]["n"] >= 0 for s in segs)
    p.cfg = {}                        # raw-config readers: the manifest,
    p.open()                          # not config, describes the bytes
    _check(p, want)
    assert p.stats("persist")[1]["source"] == "snapshot"
    p.close()


def test_raw_snapshot_back_compat_both_directions(tmp_path):
    p = Pair(tmp_path)
    p.each(lambda c: c.ingest_dataframe("sales", make_sales_df(6000),
                                        time_column="ts", target_rows=2048))
    want = _answers(p)
    p.each(lambda c: c.checkpoint("sales"))
    man = _manifest(p.t)
    assert "encoding" not in man
    assert all("enc" not in meta for meta in man["files"].values())
    p.close()
    p.open(**ENC)
    _check(p, want)
    p.stream("sales", make_sales_df(500, seed=21), time_column="ts")
    want2 = _answers(p)
    p.each(lambda c: c.checkpoint("sales"))
    assert _manifest(p.t).get("encoding")
    p.close()
    p.open()
    _check(p, want2)
    p.close()


def test_wal_tail_replays_across_format_boundary(tmp_path):
    p = Pair(tmp_path, **ENC)
    p.stream("sales", make_sales_df(3000), time_column="ts")
    p.each(lambda c: c.checkpoint("sales"))
    p.stream("sales", make_sales_df(400, seed=5), time_column="ts")
    p.stream("sales", make_sales_df(250, seed=6), time_column="ts")
    want = _answers(p)
    p.restart()
    _check(p, want)
    p.close()


def test_corrupt_encoded_blob_quarantined(tmp_path):
    p = Pair(tmp_path, **ENC)
    p.stream("sales", make_sales_df(3000), time_column="ts")
    want = _answers(p)
    p.each(lambda c: c.checkpoint("sales"))
    p.stream("sales", make_sales_df(100, seed=9), time_column="ts")
    p.each(lambda c: c.checkpoint("sales"))
    curs = []
    for c in (p.j, p.t):
        ds_root = c.persist._ds_root("sales")
        cur = SNAP.current_version(ds_root)
        curs.append(cur)
        man = SNAP.load_manifest(ds_root, cur)
        rel = next(iter(man["encoding"]["columns"]))
        with open(os.path.join(ds_root, SNAP.version_dirname(cur), rel),
                  "r+b") as f:
            f.seek(0)
            f.write(b"\xde\xad\xbe\xef")
    p.close()
    p.open()
    for c, cur in zip((p.j, p.t), curs):
        assert [q["version"]
                for q in c.persist.recovery_report["quarantined"]] == [cur]
    _check(p, want)
    p.close()


def test_compaction_reencodes_generations(tmp_path):
    p = Pair(tmp_path, **ENC)
    for seed in range(4):
        p.stream("sales", make_sales_df(1200, seed=seed), time_column="ts")
    want = _answers(p)
    rj, rt = p.each(lambda c: c.persist.compact("sales"))
    assert rt and [{k: v for k, v in r.items()} for r in rt] == rj
    assert _manifest(p.t).get("encoding")
    _check(p, want)
    p.close()
    p.cfg = {}
    p.open()
    _check(p, want)
    p.close()


def test_encoded_append_races_checkpoint_and_compaction(tmp_path):
    """Producers stream appends while a checkpoint + compact loop
    publishes encoded generations under them, in each package; both end
    with the same answers, and each recovers its live answers."""
    wants = {}
    for pkg in ("jax", "port"):
        ctx = open_ctx(pkg, tmp_path / pkg, **ENC)
        ctx.stream_ingest("sales", make_sales_df(1500, seed=0),
                          time_column="ts")
        stop, errs = threading.Event(), []

        def churn(ctx=ctx, stop=stop, errs=errs):
            try:
                while not stop.is_set():
                    ctx.checkpoint("sales")
                    ctx.persist.compact("sales")
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        t = threading.Thread(target=churn)
        t.start()
        try:
            for seed in range(1, 6):
                ctx.stream_ingest("sales", make_sales_df(700, seed=seed),
                                  time_column="ts")
        finally:
            stop.set()
            t.join()
        assert not errs, errs
        wants[pkg] = {q: ctx.sql(q).to_pandas() for q in QUERIES}
        ctx.checkpoint("sales")
        ctx.close()
        again = open_ctx(pkg, tmp_path / pkg, **ENC)
        for q in QUERIES:
            assert_answers_equal(again.sql(q).to_pandas(), wants[pkg][q],
                                 True)
        again.close()
    for q in QUERIES:
        assert_answers_equal(wants["port"][q], wants["jax"][q], True)


# -- TPC-H / SSB differentials ------------------------------------------------

@pytest.fixture(scope="module")
def star_roots(tmp_path_factory):
    """The TPC-H and SSB flat stars checkpointed raw by the JAX package
    and encoded by the port."""
    from spark_druid_olap_tpu_torch.tools import ssb, tpch
    tpch_flat = tpch.flatten(tpch.generate(sf=0.002))
    ssb_flat = ssb.flatten(ssb.generate(sf=0.003))
    roots = {}
    for pkg, enabled in (("jax", False), ("port", True)):
        root = str(tmp_path_factory.mktemp(f"enc-star-{pkg}"))
        seed = open_ctx(pkg, root, **{"sdot.encode.enabled": enabled})
        seed.ingest_dataframe("tpch_flat", tpch_flat,
                              time_column="l_shipdate", target_rows=2048)
        seed.ingest_dataframe("ssb_flat", ssb_flat,
                              time_column="lo_orderdate", target_rows=2048)
        seed.checkpoint()
        seed.close()
        roots[pkg] = root
    return roots


@pytest.fixture(scope="module")
def star_pair(star_roots):
    from spark_druid_olap_tpu.tools import ssb as jssb
    from spark_druid_olap_tpu.tools import tpch as jtpch
    from spark_druid_olap_tpu_torch.tools import ssb as tssb
    from spark_druid_olap_tpu_torch.tools import tpch as ttpch
    out = {}
    for pkg, (tpch, ssb) in (("jax", (jtpch, jssb)),
                             ("port", (ttpch, tssb))):
        ctx = open_ctx(pkg, star_roots[pkg], **{"sdot.cache.enabled": False})
        ctx.register_star_schema(tpch.star_schema("tpch_flat"))
        ctx.register_star_schema(ssb.star_schema("ssb_flat"))
        out[pkg] = ctx
    for n in out["jax"].store.names():
        assert_same_store(out["jax"].store.get(n), out["port"].store.get(n))
    yield out
    for c in out.values():
        c.close()


@pytest.mark.parametrize("suite,name", [
    ("tpch", "basic_agg"), ("tpch", "q1"), ("tpch", "q6"),
    ("tpch", "q14"), ("ssb", "q1.1"), ("ssb", "q3.1")])
def test_star_schema_encoded_vs_raw(star_pair, suite, name):
    """The port over its encoded snapshots answers as the JAX package
    over its raw ones."""
    from spark_druid_olap_tpu_torch.tools import ssb, tpch
    sql = (tpch if suite == "tpch" else ssb).QUERIES[name]
    assert_answers_equal(star_pair["port"].sql(sql).to_pandas(),
                         star_pair["jax"].sql(sql).to_pandas(), True)


# -- tiered execution over encoded chunks -------------------------------------

@pytest.fixture(scope="module")
def tiered_roots(tmp_path_factory):
    """One synthetic store checkpointed raw and encoded by each package."""
    roots = {}
    for writer in PKGS:
        for leg, enabled in (("raw", False), ("encoded", True)):
            root = tmp_path_factory.mktemp(f"enc-tier-{writer}-{leg}")
            seed = open_ctx(writer, root, **{"sdot.encode.enabled": enabled})
            seed.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                                  target_rows=4096)
            seed.checkpoint("sales")
            seed.close()
            roots[writer, leg] = root
    return roots


def _tiered(pkg, root, tmp_path, budget=1 << 20):
    """``pkg``'s tiered context over a private copy of ``root``."""
    dst = tmp_path / f"{pkg}-{os.path.basename(root)}"
    shutil.copytree(root, dst)
    return open_ctx(pkg, dst, **{"sdot.cache.enabled": False,
                                 "sdot.plan.cache.enabled": False,
                                 "sdot.tier.enabled": True,
                                 "sdot.tier.budget.bytes": budget,
                                 "sdot.tier.wave.io.bytes": budget // 4})


def _ctx_answers(ctx):
    return {q: ctx.sql(q).to_pandas() for q in QUERIES}


@pytest.mark.parametrize("writer", PKGS)
def test_tiered_encoded_differential_and_stats(tiered_roots, tmp_path,
                                               writer):
    eager = open_ctx(writer, tiered_roots[writer, "raw"])
    want = _ctx_answers(eager)
    eager.close()
    enc = {}
    for reader in PKGS:
        ctx = _tiered(reader, tiered_roots[writer, "encoded"], tmp_path)
        for q, w in _ctx_answers(ctx).items():
            assert_answers_equal(w, want[q], True)
        enc[reader] = ctx.engine.last_stats.get("encoding")
        assert enc[reader] and enc[reader]["encoded_keys"] > 0 \
            and enc[reader]["ratio"] > 1.0
        st = ctx.persist.tier.stats_snapshot()
        assert st["hot_bytes"] <= st["budget_bytes"]
        ctx.close()
    assert enc["port"] == enc["jax"]


@pytest.mark.parametrize("writer", PKGS)
def test_zone_maps_served_from_manifest_without_faults(tiered_roots,
                                                       tmp_path, writer):
    """Per-segment bounds come from the manifest's encoding block, so
    metric pruning must not decode — or even fault — a single cold
    chunk."""
    eager = open_ctx(writer, tiered_roots[writer, "raw"])
    want_bounds = eager.store.get("sales").segment_metric_bounds("qty")
    eager.close()
    for reader in PKGS:
        ctx = _tiered(reader, tiered_roots[writer, "encoded"], tmp_path)
        st0 = ctx.persist.tier.stats_snapshot()["faults"]
        mins, maxs = ctx.store.get("sales").segment_metric_bounds("qty")
        assert ctx.persist.tier.stats_snapshot()["faults"] == st0
        np.testing.assert_allclose(mins, want_bounds[0])
        np.testing.assert_allclose(maxs, want_bounds[1])
        ctx.close()


@pytest.mark.parametrize("writer", PKGS)
def test_same_budget_holds_more_encoded_chunks(tiered_roots, tmp_path,
                                               writer):
    """The hot set stores ENCODED payloads, so the same budget ends up
    holding more chunks whenever anything compressed."""
    for reader in PKGS:
        entries = {}
        for leg in ("raw", "encoded"):
            ctx = _tiered(reader, tiered_roots[writer, leg], tmp_path,
                          budget=256 * 1024)
            for q in QUERIES:
                ctx.sql(q)
            entries[leg] = ctx.persist.tier.stats_snapshot()["hot_entries"]
            ctx.close()
        assert entries["encoded"] > entries["raw"], (reader, entries)


def test_exec_helpers_equal_the_jax_helpers(tmp_path):
    """``encode/exec.py``'s header zone maps, FoR-domain day pruning, RLE
    group-by and encoded-domain reductions give the JAX package's values,
    and agree with the decoded rows."""
    from spark_druid_olap_tpu.encode import exec as JEX
    from spark_druid_olap_tpu_torch.encode import exec as TEX
    days = np.sort(_R.integers(16000, 16400, 3000)).astype(np.int32)
    dim = np.repeat(np.arange(6, dtype=np.int8), 500)
    metric = _R.uniform(size=len(dim))
    for arr, codec in ((days, C.FORDELTA), (dim, C.RLE),
                       (ARRAYS["narrow_i32"], C.BITPACK),
                       (ARRAYS["low_card_i8"], C.RAW)):
        payload, header = C.encode_array(arr, codec)
        assert TEX.chunk_bounds(header) == JEX.chunk_bounds(header)
        np.testing.assert_array_equal(TEX.decode_chunk(payload, header), arr)
        for op in ("count", "sum", "min", "max"):
            got = TEX.reduce_chunk(payload, header, op)
            assert got == JEX.reduce_chunk(payload, header, op), (codec, op)
        assert TEX.reduce_chunk(payload, header, "sum") \
            == int(arr.astype(np.int64).sum())
    day_ms = 86_400_000
    payload, header = C.encode_array(days, C.FORDELTA)
    for lo, hi in ((16100, 16101), (15000, 15990), (16399, 17000),
                   (16500, 16600)):
        iv = [(lo * day_ms, hi * day_ms)]
        assert TEX.chunk_day_overlap(header, iv) \
            == JEX.chunk_day_overlap(header, iv)
    payload, header = C.encode_array(dim, C.RLE)
    t = TEX.rle_groupby(payload, header, 6, metric)
    j = JEX.rle_groupby(payload, header, 6, metric)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(t["count"], np.bincount(dim, minlength=6))
