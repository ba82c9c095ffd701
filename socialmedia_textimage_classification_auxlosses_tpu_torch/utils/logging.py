"""Logging setup shared by all runners (reference repeats this block in every
module — e.g. ``run_mm_late.py:12-17``)."""

import logging


def get_logger(name: str) -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        level=logging.INFO,
    )
    return logging.getLogger(name)
