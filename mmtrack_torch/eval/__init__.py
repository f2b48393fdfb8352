"""Evaluation: the OPE drivers and entry (ope, batched_ope, run_ope) with
their datasets, metrics and analysis, and the VOT TraX server and entry."""
