"""Host synchronizations with the card, counted by call site: a frozen copy
of the port's ``probes/sync_sites.SyncSites`` (torch's own sync debug mode,
``torch.cuda.set_sync_debug_mode("warn")``). A site is the innermost three
frames of the port on the stack; a sync outside the port counts under
"(harness)". Counts every thread's syncs while active."""

from __future__ import annotations

import collections
import traceback
import warnings

import torch

PACKAGE = "mobile_slam_tpu_torch"


class SyncSites:
    def __init__(self):
        self.sites = collections.Counter()

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1] if PACKAGE in f.filename]
        site = " <- ".join(f"{f.filename.split(PACKAGE + '/')[-1]}:{f.lineno}"
                           for f in reversed(stack[-3:]))
        self.sites[site or "(harness)"] += 1

    def __enter__(self):
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.sites.values())
