"""McPAT/NeuroMeter-style per-component power model (paper §4.4).

Calibration strategy (documented, since the paper's exact coefficients are
not published):

* **Static (leakage) power.** Chip static power at idle temperature is the
  published idle wattage (validated for TPUv2/v3 in the paper). Leakage at
  busy-die temperature is higher; we apply a technology-dependent thermal
  uplift. Busy static power is distributed over components with per-
  generation shares calibrated to reproduce the paper's Fig 3 breakdown
  (SA 8–14%, VU 1.9–5.6%, SRAM 15.4–24.4%, HBM 9–22.4%, ICI 5.3–12%,
  other 39.1–45.8%).
* **Dynamic power.** Max dynamic power = TDP − busy static; distributed by
  a fixed activity mix and scaled by per-component utilization.

The emergent quantities the benchmarks check against the paper: busy-chip
static energy fraction 30–72% (Fig 3), ReGate-Full savings 8.5–32.8%
(Fig 17), <0.5% perf overhead (Fig 19).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hw import NPUSpec

COMPONENTS = ("sa", "vu", "sram", "hbm", "ici", "other")

# per-generation static-power shares (calibrated to paper Fig 3 ranges)
STATIC_SHARES: dict[str, dict[str, float]] = {
    "NPU-A": {"sa": 0.080, "vu": 0.019, "sram": 0.154, "hbm": 0.224,
              "ici": 0.120, "other": 0.403},
    "NPU-B": {"sa": 0.090, "vu": 0.025, "sram": 0.170, "hbm": 0.200,
              "ici": 0.100, "other": 0.415},
    "NPU-C": {"sa": 0.100, "vu": 0.035, "sram": 0.220, "hbm": 0.120,
              "ici": 0.080, "other": 0.445},
    "NPU-D": {"sa": 0.110, "vu": 0.045, "sram": 0.220, "hbm": 0.100,
              "ici": 0.067, "other": 0.458},
    "NPU-E": {"sa": 0.140, "vu": 0.056, "sram": 0.244, "hbm": 0.090,
              "ici": 0.053, "other": 0.417},
}

# dynamic activity mix at full load
DYN_SHARES = {"sa": 0.50, "vu": 0.12, "sram": 0.12, "hbm": 0.16,
              "ici": 0.04, "other": 0.06}

# leakage thermal uplift idle-temp -> busy-temp, by node
_TEMP_UPLIFT = {16: 1.35, 7: 1.65, 4: 1.85}


@dataclass(frozen=True)
class PowerModel:
    npu: NPUSpec

    @property
    def static_busy_w(self) -> float:
        return self.npu.idle_w * _TEMP_UPLIFT[self.npu.tech_nm]

    @property
    def static_w(self) -> dict[str, float]:
        shares = STATIC_SHARES[self.npu.name]
        tot = self.static_busy_w
        return {c: tot * shares[c] for c in COMPONENTS}

    @property
    def dyn_max_w(self) -> dict[str, float]:
        tot = max(10.0, self.npu.tdp_w - self.static_busy_w)
        return {c: tot * DYN_SHARES[c] for c in COMPONENTS}

    @property
    def idle_chip_w(self) -> float:
        """Powered-on, out-of-duty-cycle chip (cool die)."""
        return self.npu.idle_w

    def idle_chip_gated_w(self, gated_components=("sa", "vu", "sram", "hbm",
                                                  "ici"),
                          deep_idle_other_leak: float = 0.2) -> float:
        """Idle chip with ReGate gating everything gateable (SRAM off).

        Out of the duty cycle no program is loaded, so the core control
        plane / datapaths ("other") can also be quiesced down to the
        management island (``deep_idle_other_leak`` of their static power)
        — during busy intervals "other" is never gated (paper §3)."""
        g = self.npu.gating
        shares = STATIC_SHARES[self.npu.name]
        w = 0.0
        for c in COMPONENTS:
            if c in gated_components:
                leak = (g.leak_sram_off if c == "sram" else g.leak_off_logic)
            elif c == "other":
                leak = deep_idle_other_leak
            else:
                leak = 1.0
            w += self.npu.idle_w * shares[c] * leak
        return w
