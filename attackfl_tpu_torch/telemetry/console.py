"""Console and file logging, the port's ``attackfl_tpu/telemetry/console.py``
(reference ``src/Log.py``: the ``Logger`` that writes ``app.log`` and the
ANSI ``print_with_color`` console prints, Log.py:15-44)."""

from __future__ import annotations

import logging
import os

_COLORS = {
    "red": "\033[91m",
    "green": "\033[92m",
    "yellow": "\033[93m",
    "blue": "\033[94m",
    "magenta": "\033[95m",
    "cyan": "\033[96m",
}
_RESET = "\033[0m"


def print_with_color(text: str, color: str = "cyan") -> None:
    print(f"{_COLORS.get(color, '')}{text}{_RESET}")


class Logger:
    """File logger writing ``app.log`` under ``log_path`` (reference
    server.py:89,175; src/Log.py:15-39), one handler per file in the
    process, not propagated to the root logger."""

    def __init__(self, path: str = "./app.log"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._logger = logging.getLogger(f"attackfl_tpu_torch.{path}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            handler = logging.FileHandler(path)
            handler.setFormatter(
                logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
            self._logger.addHandler(handler)

    def log_info(self, msg: str) -> None:
        self._logger.info(msg)

    def log_warning(self, msg: str) -> None:
        self._logger.warning(msg)

    def log_error(self, msg: str) -> None:
        self._logger.error(msg)
