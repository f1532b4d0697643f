"""Helpers of the port's copies of JAX test files (``tests/test_torch_*``
copies of ``tests/test_*``): an engine decision of the port (a mode, a
route, a plan field, a stats key, an error and its message) is held
equal to the JAX package's on the same input, not to a copied literal.
"""

import spark_druid_olap_tpu as jsdot


def jax_context(config=None, frames=()):
    """A JAX ``Context`` over ``frames``: ``(name, df, ingest kwargs)``
    each, ingested as the port copy ingests them."""
    ctx = jsdot.Context(config)
    for name, df, kw in frames:
        ctx.ingest_dataframe(name, df, **kw)
    return ctx


def last_mode(ctx) -> str:
    """The mode of the context's last recorded statement."""
    return ctx.history.entries()[-1].stats["mode"]


def sql_mode(ctx, sql) -> str:
    """Runs ``sql`` on ``ctx``; the statement's recorded mode."""
    ctx.sql(sql).to_pandas()
    return last_mode(ctx)


def raised(fn):
    """``(exception class name, message)`` of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — what is compared
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn} raised nothing")


def same_error(port_fn, jax_fn):
    """Both raise: the same exception class name and message. Returns the
    port's ``(name, message)``."""
    got, want = raised(port_fn), raised(jax_fn)
    assert got == want, f"port {got} vs JAX {want}"
    return got


def jax_spec(q):
    """The port's QuerySpec as the JAX package's, through the two
    packages' serde (their JSON is one format)."""
    from spark_druid_olap_tpu.ir import serde as JSER
    from spark_druid_olap_tpu_torch.ir import serde as TSER
    return JSER.query_from_json(TSER.query_to_json(q))


def jax_engine(store, config=None, mesh=None):
    """A JAX ``QueryEngine`` over a JAX store with ``config`` (a dict)."""
    from spark_druid_olap_tpu.parallel.executor import QueryEngine
    from spark_druid_olap_tpu.utils.config import Config
    return QueryEngine(store, config=Config(config or {}), mesh=mesh)


def jax_store(*datasources):
    """A JAX ``SegmentStore`` holding ``(name, df, ingest kwargs)``
    each."""
    from spark_druid_olap_tpu.segment.ingest import ingest_dataframe
    from spark_druid_olap_tpu.segment.store import SegmentStore
    st = SegmentStore()
    for name, df, kw in datasources:
        st.register(ingest_dataframe(name, df, **kw))
    return st


def jax_stats(store, q, config=None, mesh=None) -> dict:
    """The JAX engine's ``last_stats`` for the port's spec ``q``."""
    eng = jax_engine(store, config, mesh)
    eng.execute(jax_spec(q)).to_pandas()
    return dict(eng.last_stats)


def mirrored(port, config=None):
    """Gives the port context ``port`` a JAX twin, ``port.jax``: a JAX
    ``Context`` (``config``) that every later ``port.ingest_dataframe``
    ingests into too. Returns ``port``."""
    twin = jsdot.Context(config)
    ingest = port.ingest_dataframe

    def both(name, df, *args, **kwargs):
        twin.ingest_dataframe(name, df, *args, **kwargs)
        return ingest(name, df, *args, **kwargs)
    port.ingest_dataframe = both
    port.jax = twin
    return port


def mode_as_jax(ctx, sql) -> str:
    """The mode of the port context's last statement, held equal to its
    twin's (:func:`mirrored`) on ``sql``; the twin gets the port's session
    functions first."""
    mode = last_mode(ctx)
    ctx.jax.functions.update(ctx.functions)
    assert mode == sql_mode(ctx.jax, sql), sql
    return mode


def last_mode_as_jax(ctx) -> str:
    """The mode of the port context's last statement, held equal to its
    twin's (:func:`mirrored`) on the statement's recorded SQL text."""
    entry = ctx.history.entries()[-1]
    assert entry.sql, "the last statement recorded no SQL text"
    return mode_as_jax(ctx, entry.sql)
