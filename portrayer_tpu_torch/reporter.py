"""Progress reporting (counterpart of ``portrayer_tpu/reporter.py``, the
reference's Reporter trait, src/reporter.rs).

`RenderProgress` prints a live progress line on stderr, or with CI=true a
percentage line on stdout at most every 30 s and "Done!" at the end
(reporter.rs:34-49); `NullProgress` is a no-op.  The renderer calls
``start(total)`` with its number of tiles, ``tick()`` once a tile is
traced and ``finish()`` once the image is assembled.
"""

from __future__ import annotations

import os
import sys
import time


class Reporter:
    def __init__(self, total: int = 0):
        self.total = total

    def start(self, total: int):
        self.total = total

    def tick(self, n: int = 1):
        pass

    def finish(self):
        pass


class NullProgress(Reporter):
    pass


class RenderProgress(Reporter):
    def __init__(self, total: int = 0):
        super().__init__(total)
        self.done = 0
        self.t0 = time.time()
        self.last_print = 0.0
        self.ci = os.environ.get("CI") == "true"

    def start(self, total: int):
        self.total = total
        self.done = 0
        self.t0 = time.time()

    def tick(self, n: int = 1):
        self.done += n
        now = time.time()
        interval = 30.0 if self.ci else 0.1
        if now - self.last_print < interval and self.done < self.total:
            return
        self.last_print = now
        pct = 100.0 * self.done / max(self.total, 1)
        elapsed = now - self.t0
        eta = elapsed / max(self.done, 1) * (self.total - self.done)
        if self.ci:
            print(f"{pct:.0f}%", flush=True)
        else:
            sys.stderr.write(
                f"\r[{elapsed:7.1f}s] {self.done}/{self.total} tiles "
                f"({pct:5.1f}%) eta {eta:6.1f}s"
            )
            sys.stderr.flush()

    def finish(self):
        if self.ci:
            print("Done!", flush=True)
        else:
            sys.stderr.write("\n")
            sys.stderr.flush()
