"""Package OPE results for the eval servers, port of
tools/transform_results.py (the reference's transform_got10k.py:45-52 and
transform_trackingnet.py:34-41):

    python -m mmtrack_torch.eval.transform_results got10k --results-root results --config deep_rgbd
    python -m mmtrack_torch.eval.transform_results trackingnet --results-root results --config deep_rgbd

Prints the raw zip's and the submission zip's paths.
"""

from __future__ import annotations

import argparse

from mmtrack_torch.eval.submission import transform_got10k, transform_trackingnet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="package OPE results for eval servers")
    p.add_argument("server", choices=["got10k", "trackingnet"])
    p.add_argument("--results-root", required=True)
    p.add_argument("--config", required=True, help="config name (result subdir)")
    p.add_argument("--dataset", default=None,
                   help="dataset subdir (defaults to the server name)")
    p.add_argument("--keep", action="store_true",
                   help="keep the unzipped trees (reference removes them)")
    a = p.parse_args(argv)
    fn = transform_got10k if a.server == "got10k" else transform_trackingnet
    raw_zip, submit_zip = fn(a.results_root, a.config, dataset=a.dataset or a.server,
                             cleanup=not a.keep)
    print(raw_zip)
    print(submit_zip)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
