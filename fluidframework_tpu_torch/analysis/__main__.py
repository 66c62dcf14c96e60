"""fluidlint CLI.

    python -m fluidframework_tpu_torch.analysis [paths...] [options]

Every family of the port (``core.FAMILIES``, synccheck included) over
the port's default roots. Exit status 0 when every finding is
suppressed or allowlisted, 1 otherwise (2 for usage errors). The text
report ends with one ``<family>: clean`` or ``<family>: N finding(s)``
line per family; ``--json`` and ``--sarif`` emit machine-readable
reports.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .core import (
    ALLOWLIST_PATH,
    DEFAULT_ROOTS,
    FAMILIES,
    REPO_ROOT,
    RULE_FAMILY,
    apply_allowlist,
    load_allowlist,
    run_analysis,
)


def changed_files(ref: str, repo_root: str = REPO_ROOT) -> list[str]:
    """Python files touched vs ``ref`` (committed diff + staged +
    working tree + untracked), repo-root-relative, existing only —
    the fast-local-iteration scan set for ``--changed``."""
    out: set[str] = set()
    for args in (
        ["git", "diff", "--name-only", ref, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, capture_output=True, text=True, cwd=repo_root,
                timeout=30,
            )
        except subprocess.TimeoutExpired as e:
            # the documented CLI failure contract is `error: ...` +
            # exit 2, not a raw traceback
            raise ValueError(
                f"git timed out for {' '.join(args)!r}"
            ) from e
        if proc.returncode != 0:
            raise ValueError(
                f"git failed for {' '.join(args)!r}: "
                f"{proc.stderr.strip()}"
            )
        out.update(
            line.strip() for line in proc.stdout.splitlines()
            if line.strip()
        )
    return sorted(
        p for p in out
        if p.endswith(".py")
        and os.path.exists(os.path.join(repo_root, p))
    )


def to_sarif(findings, stale) -> dict:
    """SARIF 2.1.0 (the interchange format CI diff annotators read).
    Stale allowlist entries report as tool-level notifications: they
    have no code location but must not exit 0 silently."""
    rules = sorted({f.rule for f in findings})
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "fluidlint",
                    "informationUri":
                        "docs/ANALYSIS.md",
                    "rules": [{"id": r} for r in rules],
                },
            },
            "results": [
                {
                    "ruleId": f.rule,
                    "level": "error",
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {"startLine": max(1, f.line)},
                        },
                    }],
                    # the allowlist identity, so annotation tooling
                    # can dedupe across rebases exactly as the
                    # ratchet does
                    "partialFingerprints": {"fluidlintKey": f.key},
                }
                for f in findings
            ],
            "invocations": [{
                # SARIF semantics: whether the TOOL ran to completion
                # — findings do NOT make the run unsuccessful (CI
                # consumers would discard the results exactly when
                # there is something to annotate); only a tool-level
                # fault (stale allowlist) flips it
                "executionSuccessful": not stale,
                "toolExecutionNotifications": [
                    {
                        "level": "error",
                        "message": {"text": (
                            f"stale allowlist entry '{rule} {key}' "
                            "matches no live finding — delete it"
                        )},
                    }
                    for rule, key in stale
                ],
            }],
        }],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.analysis",
        description="fluidlint: " + " + ".join(FAMILIES),
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to scan (default: the repo tree)",
    )
    parser.add_argument(
        "--changed", nargs="?", const="HEAD", default=None,
        metavar="REF",
        help="scan only python files touched vs a git ref (default "
             "HEAD when the flag is bare) — fast local iteration "
             "before the full tier-1 gate run; allowlist staleness "
             "is skipped like any partial-path scan",
    )
    parser.add_argument(
        "--rules", default=",".join(FAMILIES),
        help="comma-separated pass families to run "
             f"(default: {','.join(FAMILIES)})",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON "
             "{findings, allowlisted, stale_allowlist}",
    )
    parser.add_argument(
        "--sarif", action="store_true", dest="as_sarif",
        help="emit findings as SARIF 2.1.0 (CI diff annotation)",
    )
    parser.add_argument(
        "--allowlist", default=ALLOWLIST_PATH,
        help="allowlist file (default: analysis/allowlist.txt)",
    )
    parser.add_argument(
        "--no-allowlist", action="store_true",
        help="report grandfathered findings too",
    )
    args = parser.parse_args(argv)

    families = [f for f in args.rules.split(",") if f]
    partial_scan = bool(args.paths)
    try:
        if args.changed is not None:
            if args.paths:
                raise ValueError(
                    "--changed and explicit paths are mutually "
                    "exclusive"
                )
            roots = changed_files(args.changed, REPO_ROOT)
            partial_scan = True
            if not roots:
                # still fall through to the output stage: a docs-only
                # diff under --sarif/--json must emit a valid empty
                # report, not zero bytes of stdout
                print(
                    f"fluidlint: no python files changed vs "
                    f"{args.changed}", file=sys.stderr,
                )
        else:
            roots = args.paths or DEFAULT_ROOTS
        findings = run_analysis(
            roots=roots,
            families=families,
            repo_root=REPO_ROOT,
        ) if roots else []
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    allowlist = [] if args.no_allowlist else load_allowlist(
        args.allowlist
    )
    kept, stale = apply_allowlist(findings, allowlist)
    n_allowed = len(findings) - len(kept)
    if partial_scan:
        # a partial-path scan (explicit paths or --changed)
        # legitimately misses allowlisted findings elsewhere in the
        # tree; staleness is only meaningful (and only enforced, here
        # and in the gate test) on a full default-roots run
        stale = []

    if args.as_sarif:
        print(json.dumps(to_sarif(kept, stale), indent=2))
    elif args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in kept],
            "allowlisted": n_allowed,
            "stale_allowlist": [
                {"rule": r, "key": k} for r, k in stale
            ],
            "families": families,
        }, indent=2))
    else:
        for f in kept:
            print(f.format())
        for rule, key in stale:
            print(
                f"allowlist entry '{rule} {key}' matches no finding "
                "anymore — delete it (the ratchet only goes down)"
            )
        for fam in families:
            n = sum(RULE_FAMILY.get(f.rule) == fam for f in kept)
            print(f"{fam}: " + (f"{n} finding(s)" if n else "clean"))
        summary = (
            f"fluidlint: {len(kept)} finding(s), "
            f"{n_allowed} allowlisted, {len(stale)} stale allowlist "
            f"entr{'y' if len(stale) == 1 else 'ies'}"
        )
        print(summary, file=sys.stderr)
    return 1 if (kept or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
