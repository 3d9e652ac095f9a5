#!/usr/bin/env python
"""Quality-vs-NFE search over the tableau catalog, scored by SSIM, on the PyTorch port.

``scripts/compare_tableaux.py``'s protocol and output through
``skrample_tpu_torch.utils.tableau_search``: each tableau's row as one JSON
line, then each stage count's winner beside ``DEFAULT_PROVIDERS``' pick.

Usage: python scripts/compare_tableaux_torch.py [nfe_budget=24] [seeds=4] [flow|eps] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from skrample_tpu_torch.sampling.functional import DEFAULT_PROVIDERS  # noqa: E402
from skrample_tpu_torch.utils.tableau_search import search  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nfe_budget", type=int, nargs="?", default=24)
    ap.add_argument("seeds", type=int, nargs="?", default=4)
    ap.add_argument("family", nargs="?", default="flow", choices=("flow", "eps"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows, trained = search(args.nfe_budget, args.seeds, args.family, args.device)
    for row in rows:
        print(json.dumps(row))
    print("\n# stage-class winners (by SSIM)" if trained else "\n# stage-class winners (by MSE)")
    by_stage: dict[int, list[dict]] = {}
    for row in rows:
        by_stage.setdefault(row["stages"], []).append(row)
    for stages, group in sorted(by_stage.items()):
        best = group[0]
        shipped = str(DEFAULT_PROVIDERS.get(stages, ""))
        mark = "  <- DEFAULT_PROVIDERS pick" if shipped and shipped == best["tableau"] else (
            f"  (shipped: {shipped})" if shipped else ""
        )
        print(f"# {stages:2d} stages: {best['tableau']} ssim={best['ssim_vs_euler200']}{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
