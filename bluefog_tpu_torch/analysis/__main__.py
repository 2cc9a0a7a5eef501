"""``python -m bluefog_tpu_torch.analysis``: run both analyzer passes
and exit 1 on any finding the baseline does not suppress.

The JAX package's CLI (``bfcheck``) with ``--no-jaxpr`` named
``--no-step``.  The step sweep runs on the card unless ``--device cpu``
is given; there is no fallback: with no card and no ``--device cpu`` it
exits 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from bluefog_tpu_torch.analysis import (Finding, default_root,
                                        format_findings, load_baseline,
                                        split_suppressed)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.analysis",
        description="bluefog_tpu_torch contract checker: AST lint + step "
                    "check of the weights-as-data and collective "
                    "contracts")
    parser.add_argument("--root", default=None,
                        help="repo root to scan (default: cwd when it "
                             "holds pyproject.toml, else the installed "
                             "package's tree)")
    parser.add_argument("--baseline", default=None,
                        help="suppression file (default: the committed "
                             "bluefog_tpu_torch/analysis/baseline.txt)")
    parser.add_argument("--no-lint", action="store_true",
                        help="skip the AST lint pass")
    parser.add_argument("--no-step", action="store_true",
                        help="skip the step sweep (runs every train-step "
                             "variant on 8 stacked ranks)")
    parser.add_argument("--no-serving", action="store_true",
                        help="within the step sweep, skip the serving "
                             "resident programs")
    parser.add_argument("--device", default="cuda",
                        help="where the step sweep runs (default: cuda)")
    parser.add_argument("--list-baseline", action="store_true",
                        help="print the active suppression keys and "
                             "exit")
    args = parser.parse_args(argv)

    baseline = load_baseline(args.baseline)
    if args.list_baseline:
        for key in baseline:
            print(key)
        return 0

    if not args.no_step and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("bluefog_tpu_torch.analysis: the step sweep runs on the "
                  "card, and torch.cuda.is_available() is false; pass "
                  "--device cpu (or --no-step)", file=sys.stderr)
            return 2

    findings: List[Finding] = []
    if not args.no_lint:
        from bluefog_tpu_torch.analysis.lint import run_lint

        findings += run_lint(args.root or default_root())

    if not args.no_step:
        from bluefog_tpu_torch.analysis.step_check import run_sweep

        findings += run_sweep(include_serving=not args.no_serving,
                              device=args.device)

    active, suppressed = split_suppressed(findings, baseline)
    if active:
        print(format_findings(active))
    print(f"bluefog_tpu_torch.analysis: {len(active)} finding(s), "
          f"{len(suppressed)} baseline-suppressed", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
