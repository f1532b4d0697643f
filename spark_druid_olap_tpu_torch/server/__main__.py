"""``python -m spark_druid_olap_tpu_torch.server [--port P] [--tpch SF]
[--device cuda|cpu]``

Port of ``spark_druid_olap_tpu/server/__main__.py``. ``--device`` picks
the serving device: ``cuda`` by default, and without a CUDA device the
server refuses to start (``--device cpu`` runs it on the CPU).

≈ ``scripts/start-sparklinedatathriftserver.sh`` launching the wrapper
thriftserver; ``--tpch`` preloads the TPC-H star for demos/benchmarks.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8082)
    ap.add_argument("--tpch", type=float, default=None,
                    help="preload TPC-H at this scale factor")
    ap.add_argument("--device", default="cuda",
                    help="serving device: cuda (default) or cpu")
    ap.add_argument("--parquet", action="append", default=[],
                    metavar="NAME=PATH[:TIMECOL]",
                    help="ingest a parquet file as a datasource")
    args = ap.parse_args(argv)

    def setup(ctx):
        if args.tpch is not None:
            from spark_druid_olap_tpu_torch.tools import tpch
            print(f"loading TPC-H SF{args.tpch} ...")
            tpch.setup_context(ctx, sf=args.tpch)
        for spec in args.parquet:
            name, rest = spec.split("=", 1)
            path, _, tcol = rest.partition(":")
            ctx.ingest_parquet(name, path, time_column=tcol or None)

    from spark_druid_olap_tpu_torch.server.http import serve
    serve(host=args.host, port=args.port, setup=setup, device=args.device)


if __name__ == "__main__":
    main()
