"""The card: the check that it is there, its name and power limit, and the
host clock's synchronisation with it.

A measurement runs on CUDA cards only.  :func:`require_cards` ends the run
(exit code 2, no result) where torch sees no card or fewer than the cell
asks for; nothing falls back to the CPU.  :class:`Device` wraps what the
window needs of the device (synchronise, the peak of allocated memory);
the CPU form of it exists for the tests alone, which drive a run at a
small size through the plain kernels."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(SystemExit):
    def __init__(self, msg):
        print("benchmark: %s; the benchmark measures CUDA cards only and "
              "does not fall back to the CPU" % msg, file=sys.stderr)
        super().__init__(2)


def require_cards(n):
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard("the cell needs %d cards, torch sees %d"
                     % (n, torch.cuda.device_count()))


def power_limit():
    """The card's name and power limit as nvidia-smi prints them, or a
    note that it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return "nvidia-smi not read (%s)" % exc


class Device:
    def __init__(self, name="cuda"):
        self.torch = torch.device(name)
        self.cuda = self.torch.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.torch)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.torch)

    def peak_bytes(self):
        return (int(torch.cuda.max_memory_allocated(self.torch))
                if self.cuda else 0)

    def describe(self, count):
        """The result line's ``device`` entry (without the peak)."""
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": count}
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.torch),
                "count": count}
