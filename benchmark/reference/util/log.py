"""Loggers of the reference: the standard library's, unadorned."""

from __future__ import annotations

import logging


def get_logger(name: str, *args, **kwargs) -> logging.Logger:
    return logging.getLogger(name)
