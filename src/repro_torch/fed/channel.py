"""Uplink channel configuration (port of ``repro.fed.channel``, ``ideal`` only).

The ideal uplink is an error-free digital link: every client's packed
words reach the PS exactly, with zero added variance and no outage.  The
``awgn``, ``rayleigh`` and ``mimo_mac`` families are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch import not_in_slice

__all__ = ["ChannelConfig", "check_ported"]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    kind: str = "ideal"  # ideal | awgn | rayleigh | mimo_mac
    snr_db: float = 20.0
    outage_gain: float = 0.05
    n_rx: int = 8
    csi_error: float = 0.0
    combiner: str = "lmmse"


def check_ported(cfg: ChannelConfig) -> None:
    if cfg.kind != "ideal":
        raise not_in_slice(f"channel {cfg.kind!r}", "item 5")
