"""The examples' shared command line: ``--device`` (the CUDA card unless
``cpu`` is asked for)."""
from __future__ import annotations

import argparse


def parse_device(argv, description: str):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions; default: the card")
    return ap.parse_args(argv).device
