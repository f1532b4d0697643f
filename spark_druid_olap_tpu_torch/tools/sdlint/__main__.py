"""``python -m spark_druid_olap_tpu_torch.tools.sdlint`` — CI entrypoint.

Port of the JAX package's ``tools/sdlint/__main__.py``; the default
root is the ``spark_druid_olap_tpu_torch`` package.

Exit codes: 0 = clean (every finding baselined), 1 = unbaselined
findings, 2 = invalid baseline (entry without a justification).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from spark_druid_olap_tpu_torch.tools.sdlint import PASSES
from spark_druid_olap_tpu_torch.tools.sdlint.core import (Baseline, Project,
                                                    report_human,
                                                    report_json, run_passes)


def default_root() -> str:
    # .../spark_druid_olap_tpu_torch/tools/sdlint/__main__.py -> the package
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sdlint",
        description="domain-aware static analysis for "
                    "spark_druid_olap_tpu_torch")
    ap.add_argument("--root", default=None,
                    help="package directory to scan (default: the "
                         "spark_druid_olap_tpu_torch package)")
    ap.add_argument("--package", default="spark_druid_olap_tpu_torch",
                    help="dotted package name the root maps to")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: <root>/tools/sdlint/"
                         "baseline.json; 'none' disables)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--format", choices=("human", "json"), default=None,
                    help="report format (--json is shorthand for "
                         "--format json)")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only findings in files changed vs git "
                         "HEAD (analysis still sees the whole project, "
                         "so cross-module resolution is unaffected)")
    ap.add_argument("--timing", action="store_true",
                    help="per-pass wall-clock report on stderr")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root or default_root())
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    bad = [p for p in passes if p not in PASSES]
    if bad:
        ap.error(f"unknown pass(es): {', '.join(bad)}")

    if args.baseline == "none":
        baseline = Baseline()
    else:
        bpath = args.baseline or os.path.join(root, "tools", "sdlint",
                                              "baseline.json")
        baseline = Baseline.load(bpath)
    missing = baseline.missing_justifications()
    if missing:
        for e in missing:
            print(f"sdlint: baseline entry missing justification: "
                  f"{e.get('pass')}/{e.get('rule')} {e.get('symbol')}",
                  file=sys.stderr)
        return 2

    project = Project(root, package=args.package)
    timing = {} if args.timing else None
    findings = run_passes(project, passes, timing=timing)
    if args.changed_only:
        changed = _changed_files(root)
        if changed is not None:
            findings = [f for f in findings if f.path in changed]
    if timing is not None:
        total = sum(timing.values())
        for name, secs in sorted(timing.items(), key=lambda kv: -kv[1]):
            print(f"sdlint: timing {name:>12s} {secs * 1000:8.1f} ms",
                  file=sys.stderr)
        print(f"sdlint: timing {'total':>12s} {total * 1000:8.1f} ms",
              file=sys.stderr)
    if args.json or args.format == "json":
        print(report_json(findings, baseline))
        new = sum(1 for f in findings if not baseline.matches(f))
    else:
        new = report_human(findings, baseline)
    return 1 if new else 0


def _changed_files(root: str):
    """Paths (relative to ``root``) changed vs HEAD, including staged
    and untracked files; None when git is unavailable (fail open: the
    full report is better than no report)."""
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=all"],
            cwd=root, capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            return None
        top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                             cwd=root, capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    changed = set()
    for line in out.stdout.splitlines():
        name = line[3:].split(" -> ")[-1].strip().strip('"')
        abspath = os.path.join(top, name)
        rel = os.path.relpath(abspath, root)
        if not rel.startswith(".."):
            changed.add(rel)
    return changed


if __name__ == "__main__":
    sys.exit(main())
