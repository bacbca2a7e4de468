"""The port's contract checker: static rules over the port's Python, its
dispatch predicates and its CUDA sources (twin of ``repro/analysis``).
``python -m repro_torch.analysis`` is the gate; ``--list-rules`` prints the
catalog."""
from repro_torch.analysis.engine import (Context, Finding, Report, Rule,
                                         all_rules, find_root, iter_files,
                                         load_baseline, render_json,
                                         render_text, run)

__all__ = ["Context", "Finding", "Report", "Rule", "all_rules", "find_root",
           "iter_files", "load_baseline", "render_json", "render_text",
           "run"]
