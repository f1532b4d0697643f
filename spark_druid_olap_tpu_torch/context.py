"""Session context — the port's entry point.

Port of ``spark_druid_olap_tpu/context.py``: ``Context(config, device,
mesh, auto_mesh)`` wires the SQL front end (``sql``, ``explain``), the planner's catalog of
star schemas, the query history, the named lookups, the materialized
rollups, the extension modules (``sdot.modules``, ``install_module``), the
ingest entry points (``ingest_dataframe`` / ``_parquet`` / ``_csv`` /
``_parquet_stream`` and ``stream_ingest``) and the engine over the segment
store. The device is explicit and passed down to the engine: the default is
``"cuda"``, and with no CUDA device the constructor raises instead of
running on the CPU. Tests pass ``device="cpu"``. A ``mesh``
(``parallel/mesh.make_mesh``: one device per slot, a device may repeat)
lets the engine shard a scan over its slots (``parallel/meshexec.py``);
its first device is then the default device. ``auto_mesh=True`` or
``sdot.mesh.auto`` builds a mesh over every card when more than one is
visible, and ``reshard`` rebuilds the mesh over other devices. With
``sdot.persist.path`` set, the context builds a persist manager
(``persist/``) and recovers the root at construction; ``stream_ingest``
then journals every batch before it is queryable, and ``checkpoint`` /
``close`` publish and stop. With ``sdot.cluster.nodes`` set and
``sdot.cluster.role`` ``broker``, the context attaches the cluster client
(``cluster/broker.py``) to its engine: eligible queries scatter to the
historicals and merge, and ``stream_ingest`` pushes each acknowledged
batch to its time-matched shard's owners. Historicals are built by
``cluster/historical.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.metadata.catalog import Catalog
from spark_druid_olap_tpu_torch.metadata.history import QueryHistory
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.segment.ingest import (
    ingest_csv,
    ingest_dataframe,
    ingest_parquet,
)
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.utils import host_eval as _he
from spark_druid_olap_tpu_torch.utils.config import (
    CLUSTER_NODES,
    CLUSTER_ROLE,
    Config,
    MESH_AUTO,
    MODULES,
    PERSIST_PATH,
    QUERY_HISTORY,
    QUERY_HISTORY_SIZE,
    SEGMENT_ROWS,
)


class Context:
    def __init__(self, config: Optional[Dict] = None, device=None,
                 mesh=None, auto_mesh: bool = False):
        if device is None:
            device = mesh[0] if mesh else "cuda"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "spark_druid_olap_tpu_torch.Context: no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self.device = device
        self.config = Config(config)
        if mesh is None and device.type == "cuda" \
                and (auto_mesh or bool(self.config.get(MESH_AUTO))) \
                and torch.cuda.device_count() > 1:
            from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh()
            self.device = device = mesh[0]
        self.mesh = tuple(torch.device(d) for d in mesh) if mesh else None
        self.store = SegmentStore()
        self.engine = QueryEngine(self.store, self.config, device,
                                  self.mesh)
        self.catalog = Catalog(self.store)
        # disabled history keeps the registry but records nothing
        self.history = QueryHistory(
            self.config.get(QUERY_HISTORY_SIZE)
            if self.config.get(QUERY_HISTORY) else 0)
        # named lookup tables for the SQL LOOKUP(col, 'name') function
        self.lookups: Dict[str, Dict[str, Optional[str]]] = {}
        # materialized rollup registry: name -> mv.registry.RollupDef;
        # the planner consults it for automatic rewrite (mv/match.py)
        self.rollups: Dict[str, object] = {}
        # module extension points (utils/modules.py): scalar functions
        # (the process-wide host_eval registry, as in the JAX package),
        # spec rewrite rules and front statement handlers
        self.functions = _he.EXTRA_FUNCTIONS
        self.spec_rules: List = []
        self.statement_handlers: List = []
        self.modules: List = []
        mods_csv = self.config.get(MODULES)
        if mods_csv:
            from spark_druid_olap_tpu_torch.utils.modules import (
                install_from_config)
            self.modules = install_from_config(self, mods_csv)
        # durable persistence (persist/): deep-storage snapshots + ingest
        # WAL + startup recovery; None when sdot.persist.path is unset.
        # Recovery binds nothing to the device: the first statement does
        self.persist = None
        ppath = self.config.get(PERSIST_PATH)
        if ppath:
            from spark_druid_olap_tpu_torch.persist.manager import (
                PersistManager)
            self.persist = PersistManager(self, ppath)
            self.persist.recover()
            self.persist.start_background()
        # distributed serving tier (cluster/): a broker attaches the
        # scatter/merge client to its engine; historicals are built by
        # cluster/historical.py (they set sdot.cluster.role=historical
        # and never attach a client — no recursive scatter)
        self.cluster = None
        if self.config.get(CLUSTER_NODES) \
                and self.config.get(CLUSTER_ROLE) == "broker":
            from spark_druid_olap_tpu_torch.cluster.broker import (
                ClusterClient)
            self.cluster = ClusterClient(self)
            self.engine.cluster = self.cluster
        # the host tier runs uncorrelated sub-statements through the
        # engine when they push down (planner/host_exec.try_engine);
        # differential oracles turn it off to stay engine-free
        self.host_engine_assist = True

    def reshard(self, devices=None) -> None:
        """Rebuild the engine's mesh over ``devices`` (default: the
        mesh's slots whose device still answers); one device leaves no
        mesh (``QueryEngine.reshard``)."""
        self.engine.reshard(devices)
        self.mesh = self.engine.mesh
        self.device = self.engine.device

    def install_module(self, module) -> None:
        """Install an extension module programmatically (≈ adding to
        ``sdot.modules``)."""
        module.install(self)
        self.modules.append(module)

    # -- ingest / registration ------------------------------------------------
    def _ingest_kwargs(self, kwargs):
        """Segment sizing defaults to ``sdot.segment.target.rows``."""
        if "target_rows" not in kwargs:
            kwargs = {**kwargs, "target_rows": self.config.get(SEGMENT_ROWS)}
        return kwargs

    def ingest_dataframe(self, name, df, **kwargs):
        """Ingest a DataFrame (``segment/ingest.py``)."""
        ds = ingest_dataframe(name, df, **self._ingest_kwargs(kwargs))
        self.store.register(ds)
        return ds

    def ingest_parquet(self, name, path, **kwargs):
        """Read a Parquet file whole and ingest it."""
        ds = ingest_parquet(name, path, **self._ingest_kwargs(kwargs))
        self.store.register(ds)
        return ds

    def ingest_csv(self, name, path, **kwargs):
        """Read a CSV file whole and ingest it."""
        ds = ingest_csv(name, path, **self._ingest_kwargs(kwargs))
        self.store.register(ds)
        return ds

    def ingest_parquet_stream(self, name, path, **kwargs):
        """Out-of-core Parquet ingest (row-group streaming,
        ``segment/stream_ingest.py``): peak host memory is the final
        columns plus one batch, for files whose pandas form would not fit."""
        from spark_druid_olap_tpu_torch.segment.stream_ingest import (
            ingest_parquet_stream)
        ds = ingest_parquet_stream(name, path, **self._ingest_kwargs(kwargs))
        self.store.register(ds)
        return ds

    def stream_ingest(self, name, df, **kwargs):
        """Streaming append (≈ Druid realtime ingest,
        ``segment/append.py``): create the datasource on the first batch,
        append rows after; an empty batch changes nothing. Returns the new
        immutable Datasource value, registered under ``name``, so the
        store's version bump invalidates cached answers and marks rollups
        on it stale.

        With persistence on (``sdot.persist.path``) each batch is
        journaled to the write-ahead log and fsynced BEFORE it becomes
        queryable, so a committed batch survives kill -9
        (``persist/wal.py``).

        When an ``ingest`` WLM lane is configured, each batch takes a lane
        slot for its apply, so producers share the admission fabric with
        queries. On a broker, an acked batch is additionally pushed to the
        time-matched shard's owners (``cluster/broker.py``) so distributed
        reads keep read-your-writes; the push is an optimization, never
        part of the durability or ACK path."""
        from spark_druid_olap_tpu_torch.segment.append import (
            apply_stream_ingest)
        kwargs = self._ingest_kwargs(kwargs)
        wlm = self.engine.wlm
        ticket = wlm.admit_ingest()
        cl = self.cluster
        token = cl.ingest_begin(name) if cl is not None else None
        acked_df = None
        try:
            if self.persist is not None:
                ds = self.persist.stream_ingest(name, df, kwargs)
            else:
                ds = apply_stream_ingest(self, name, df, kwargs)
            acked_df = df
            return ds
        finally:
            if token is not None:
                cl.ingest_finish(token, name, acked_df, kwargs)
            if ticket is not None:
                wlm.release(ticket)

    def checkpoint(self, name: Optional[str] = None):
        """Publish snapshot(s) to deep storage (requires
        ``sdot.persist.path``). ``name=None`` checkpoints every complete
        datasource. Returns the checkpoint summaries."""
        if self.persist is None:
            raise RuntimeError(
                "persistence is disabled; set sdot.persist.path")
        if name is not None:
            return [self.persist.checkpoint(name)]
        return self.persist.checkpoint_all()

    def close(self) -> None:
        """Stop background machinery (the persist checkpointer and
        compactor, the cluster client's prober and scatter pool) and
        close the journals. Safe to call more than once; the context
        remains usable for queries."""
        if self.persist is not None:
            self.persist.stop()
        if self.cluster is not None:
            self.cluster.close()
            self.cluster = None
            self.engine.cluster = None

    def register_star_schema(self, star_schema) -> None:
        """Declare a star schema (``metadata/star.py``): joins over its
        tables collapse onto its flat datasource."""
        self.catalog.register_star_schema(star_schema)

    def register_lookup(self, name: str, mapping: Dict) -> None:
        """Register a named value-translation map usable as
        ``LOOKUP(col, 'name')`` in SQL (≈ Druid lookup registration)."""
        self.lookups[name] = {str(k): (None if v is None else str(v))
                              for k, v in mapping.items()}

    # -- query ----------------------------------------------------------------
    def execute(self, q: S.QuerySpec) -> QueryResult:
        """Execute a raw engine QuerySpec (≈ ``ON DRUIDDATASOURCE ...
        EXECUTE QUERY`` in the reference)."""
        r = self.engine.execute(q)
        self.history.record(q, dict(self.engine.last_stats))
        return r

    def sql(self, query: str, query_id: Optional[str] = None,
            lane: Optional[str] = None, tenant: Optional[str] = None,
            priority: Optional[int] = None) -> QueryResult:
        """Parse, plan and run one SQL statement (``sql/session.py``).
        ``query_id`` makes it cancellable (``engine.cancel``); ``lane``,
        ``tenant`` and ``priority`` route its engine queries through WLM
        admission (``wlm/``)."""
        from spark_druid_olap_tpu_torch.sql.session import run_sql
        return run_sql(self, query, query_id=query_id, lane=lane,
                       tenant=tenant, priority=priority)

    def explain(self, query: str) -> str:
        """The pushdown plan of one statement, without running it."""
        from spark_druid_olap_tpu_torch.sql.session import explain_sql
        return explain_sql(self, query)
