"""Per-slot decode-pattern refresh state (port of
``repro/serving/refresh.py``).

Adaptive refresh (``EngineConfig.refresh_every``) re-scores a slot's
resident KV against its *recent-query window*: the last ``block_size``
post-rope decode queries of every layer.  :class:`RefreshState` holds that
window as a ring indexed by ``pos % block_size`` beside the refresh
counters.  When a refresh fires at a block-aligned position ``n``, ring
rows ``0 .. block_size-1`` are the queries of positions ``[n − block_size,
n)`` in order — the globally-last queries the strip kernel's causal rows
assume, which is why refresh only fires at block boundaries.  ``filled``
guards the first window after an admission or a resume: a refresh needs a
full block of consecutive queries.

The ring is a tensor on the serve's device.  On the card it is kept in the
page pool's dtype, so :meth:`RefreshState.window` feeds the strip kernel
without a host round trip (the kernel takes q and k of one dtype); on the
CPU it is float32, as the reference's ring is.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RefreshState:
    """One slot's refresh bookkeeping (dropped when the slot is vacated or
    preempted)."""
    qring: torch.Tensor     # (block_size, L, H, hd) recent post-rope queries
    last_refresh_pos: int   # position of the last refresh (the admission
                            # position before the first): the cadence base
    filled: int = 0         # consecutive captured steps, saturating at
                            # block_size (the window's warm-up guard)
    horizon_end: int = 0    # exclusive block bound of the last refresh's
                            # dense horizon; 0 = row still frozen
    deferred_cow: int = 0   # refreshes deferred on a shared page
    extensions: int = 0     # horizon extensions spliced for this slot

    @property
    def block_size(self) -> int:
        return self.qring.shape[0]

    def record(self, pos: int, q_step: torch.Tensor) -> None:
        """Capture one decode step's queries ``(L, H, hd)`` at position
        ``pos``."""
        self.qring[pos % self.block_size] = q_step
        self.filled = min(self.filled + 1, self.block_size)

    def window_ready(self, pos: int) -> bool:
        """A window is usable only at a block-aligned ``pos`` with a full
        block of consecutive queries behind it."""
        return pos % self.block_size == 0 and self.filled >= self.block_size

    def window(self) -> torch.Tensor:
        """The ``(L, H, block_size, hd)`` query window, oldest row first
        (valid when :meth:`window_ready` holds)."""
        return self.qring.movedim(0, 2).contiguous()


def make_refresh_state(num_layers: int, num_heads: int, head_dim: int,
                       block_size: int, pos: int, *,
                       dtype=torch.float32, device=None) -> RefreshState:
    """Fresh state for a slot just admitted (or resumed) at ``pos``."""
    return RefreshState(
        qring=torch.zeros((block_size, num_layers, num_heads, head_dim),
                          dtype=dtype, device=device),
        last_refresh_pos=int(pos))
