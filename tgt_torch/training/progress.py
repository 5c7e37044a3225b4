"""Progress reporting: tqdm when interactive, line-printing fallback for logs
(counterpart of tgt_tpu/training/progress.py).

As the reference Progress (lib/training/progress.py:6-73
and selection logic training.py:174-193): non-TTY environments get periodic
single-line updates with rate and ETA instead of control-character bars.
"""
from __future__ import annotations

import sys
import time
from typing import Iterable, Iterator, Optional


class Progress:
    """Minimal tqdm-compatible iterator wrapper that prints plain lines."""

    def __init__(self, iterable: Optional[Iterable] = None, total: Optional[int] = None,
                 desc: str = "", miniters: float = 0.05, file=None):
        self.iterable = iterable
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        self.desc = desc
        self.min_interval = max(1, int((self.total or 100) * miniters)) \
            if miniters < 1 else int(miniters)
        self.file = file or sys.stdout
        self.n = 0
        self._start = time.time()

    def update(self, k: int = 1) -> None:
        self.n += k
        if self.n % self.min_interval == 0 or self.n == self.total:
            self._print()

    def _print(self) -> None:
        dt = time.time() - self._start
        rate = self.n / dt if dt > 0 else 0
        msg = f"{self.desc}: {self.n}"
        if self.total:
            eta = (self.total - self.n) / rate if rate > 0 else float("inf")
            msg += f"/{self.total} ({100*self.n/self.total:.0f}%) eta {eta:.0f}s"
        msg += f" [{rate:.2f} it/s]"
        print(msg, file=self.file, flush=True)

    def close(self) -> None:
        if self.n % self.min_interval != 0:
            self._print()

    def __iter__(self) -> Iterator:
        for x in self.iterable:
            yield x
            self.update()
        self.close()


def progbar(iterable, total=None, desc="", disable_tqdm=False):
    """tqdm if a TTY and available, else the plain-line Progress fallback."""
    if not disable_tqdm and sys.stdout.isatty():
        try:
            from tqdm import tqdm
            return tqdm(iterable, total=total, desc=desc, dynamic_ncols=True)
        except ImportError:
            pass
    return Progress(iterable, total=total, desc=desc)
