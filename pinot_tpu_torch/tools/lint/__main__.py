"""``python -m pinot_tpu_torch.tools.lint [--baseline FILE] [paths...]``

Runs every checker family and exits non-zero on any finding not covered
by the baseline (or an inline ``# lint: ignore[...]``). With no paths,
lints the whole ``pinot_tpu_torch`` package. Stdlib-only: runs before
torch can be imported.

``--json`` prints one JSON object per finding (key, family, file, line,
message) for CI / bench-harness annotation; ``--sarif`` prints one SARIF
2.1.0 log for code-scanning UIs (one reportingDescriptor per family);
``--families`` restricts the run to a comma-separated subset (see
``--list-families``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pinot_tpu_torch.tools.lint.core import (
    DEFAULT_BASELINE,
    checker_names,
    run_lint,
    select_changed,
)


def to_sarif(findings) -> dict:
    """SARIF 2.1.0 log for the findings: one run, one rule per family.

    The shape code-scanning UIs ingest — ``runs[0].tool.driver.rules``
    enumerates every registered family (so a clean run still advertises
    what was checked), each result carries the stable baseline key as
    its ``partialFingerprints`` entry so re-runs dedupe line moves the
    same way the baseline does.
    """
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "https://example.invalid/graftlint",
                "rules": [{"id": name,
                           "shortDescription": {"text": name}}
                          for name in checker_names()],
            }},
            "results": [{
                "ruleId": f.checker,
                "level": "error",
                "message": {"text": f.message},
                "partialFingerprints": {"graftlintKey/v1": f.key},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace(os.sep, "/")},
                        "region": {"startLine": max(1, f.line)},
                    },
                }],
            } for f in findings],
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.lint",
        description="AST + dataflow invariant checker: lock discipline, "
                    "lease pairing, tracer safety, wire/config "
                    "consistency, kernel param protocol, device-sync "
                    "taint, HBM accounting conservation.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint "
                         "(default: the pinot_tpu_torch package)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON of accepted finding keys "
                         "(default: tools/lint/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--keys", action="store_true",
                    help="print baseline keys instead of messages "
                         "(for composing baseline entries)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output: one JSON object per "
                         "finding (key, family, file, line, message)")
    ap.add_argument("--sarif", action="store_true", dest="as_sarif",
                    help="emit one SARIF 2.1.0 log on stdout (one rule "
                         "per family) for code-scanning UIs")
    ap.add_argument("--families", default=None, metavar="F1,F2",
                    help="run only the named checker families "
                         "(comma-separated; see --list-families)")
    ap.add_argument("--list-families", action="store_true",
                    help="print the registered family names and exit")
    ap.add_argument("--changed", default=None, metavar="GIT_REF",
                    help="lint only package files changed vs GIT_REF, "
                         "plus their direct imports and transitive "
                         "reverse importers (the file set the "
                         "interprocedural families need)")
    args = ap.parse_args(argv)

    if args.list_families:
        for name in checker_names():
            print(name)
        return 0

    families = None
    if args.families is not None:
        families = [s.strip() for s in args.families.split(",") if s.strip()]
        known = set(checker_names())
        unknown = [f for f in families if f not in known]
        if unknown:
            print(f"unknown families: {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2

    paths = args.paths
    if not paths:
        # the package directory, found without importing it (its
        # __init__ would import torch)
        paths = [os.path.normpath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            os.pardir, os.pardir))]

    wp_root = None
    if args.changed is not None:
        if args.paths:
            print("--changed replaces explicit paths; pass one or the "
                  "other", file=sys.stderr)
            return 2
        # whole-program families (threads, configkeys) still analyze the
        # full package; only their findings are scoped to the changed set
        wp_root = paths[0]
        try:
            paths = select_changed(args.changed, paths[0])
        except Exception as e:  # not a repo / bad ref: loud, non-lint exit
            print(f"--changed {args.changed}: {e}", file=sys.stderr)
            return 2
        if not paths:
            if args.as_sarif:
                print(json.dumps(to_sarif([]), sort_keys=True))
            elif not args.as_json:
                print("graftlint: no changed package files",
                      file=sys.stderr)
            return 0

    baseline = None if args.no_baseline else args.baseline
    new, accepted = run_lint(paths, baseline=baseline, families=families,
                             whole_program_root=wp_root)
    if args.as_sarif:
        print(json.dumps(to_sarif(new), indent=2, sort_keys=True))
        return 1 if new else 0
    for f in new:
        if args.as_json:
            print(json.dumps({"key": f.key, "family": f.checker,
                              "file": f.path, "line": f.line,
                              "message": f.message}, sort_keys=True))
        else:
            print(f.key if args.keys else f.render())
    n_sup = len(accepted)
    if not args.as_json:
        print(f"graftlint: {len(new)} finding(s)"
              + (f", {n_sup} baselined/suppressed" if n_sup else ""),
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
