"""Console + file logger (reference: util/logger.py:33-91, minus termcolor:
ANSI codes are emitted directly), the port of pcf_tpu/utils/logger.py under
the name "pcf_torch"."""

from __future__ import annotations

import functools
import logging
import os
import sys


class _ColorFormatter(logging.Formatter):
    GREEN = "\x1b[32m"
    RED = "\x1b[31m\x1b[4m"
    RESET = "\x1b[0m"

    def formatMessage(self, record):
        log = super().formatMessage(record)
        if record.levelno == logging.WARNING:
            prefix = f"{self.RED}WARNING{self.RESET}"
        elif record.levelno in (logging.ERROR, logging.CRITICAL):
            prefix = f"{self.RED}ERROR{self.RESET}"
        else:
            return log
        return log.replace(record.levelname, prefix, 1)


@functools.lru_cache()
def get_logger(output_dir: str | None = None, name: str = "pcf_torch",
               distributed_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger

    fmt = "[%(asctime)s] %(name)s %(levelname)s: %(message)s"
    datefmt = "%m/%d %H:%M:%S"

    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(_ColorFormatter(fmt=fmt, datefmt=datefmt))
    logger.addHandler(ch)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt=datefmt))
        logger.addHandler(fh)
    return logger
