"""Carbon-efficiency analysis (paper §6.6, Figs 24–25).

Operational carbon = electricity x carbon intensity x PUE, with a 60%
duty cycle: during the idle 40% the chip still burns idle power (NoPG) or
the deeply-gated idle power (ReGate). Embodied carbon amortizes over the
device lifespan; the optimal lifespan trades embodied savings (keep chips
longer) against the worsening operational efficiency of old generations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.hw import NPUS, NPUSpec, get_npu
from repro_torch.core.power import PowerModel

CARBON_INTENSITY = 0.0624   # kgCO2e/kWh (paper: Google 2024 report)
PUE = 1.1
DUTY_CYCLE = 0.60
HOURS_PER_YEAR = 8766.0
# industrial electricity price used by the fleet plane's cost roll-up
# (US EIA industrial average, $/kWh at the meter — PUE applied on top)
USD_PER_KWH = 0.08

# embodied carbon per chip+share of system, kgCO2e (from the cradle-to-grave
# TPU study the paper cites [75]; interpolated for A/B/E)
EMBODIED_KG = {"NPU-A": 90.0, "NPU-B": 120.0, "NPU-C": 150.0,
               "NPU-D": 180.0, "NPU-E": 220.0}


def joules_to_kwh(j: float) -> float:
    return j / 3.6e6


@dataclass(frozen=True)
class CarbonReport:
    workload: str
    npu: str
    policy: str
    operational_kg_per_year: float
    idle_kg_per_year: float

    @property
    def total_kg_per_year(self) -> float:
        return self.operational_kg_per_year + self.idle_kg_per_year


def yearly_carbon(avg_busy_power_w: float, npu: NPUSpec | str,
                  gated_idle: bool, *, duty: float = DUTY_CYCLE,
                  workload: str = "", policy: str = "") -> CarbonReport:
    npu = get_npu(npu) if isinstance(npu, str) else npu
    pm = PowerModel(npu)
    idle_w = pm.idle_chip_gated_w() if gated_idle else pm.idle_chip_w
    busy_kwh = avg_busy_power_w * duty * HOURS_PER_YEAR / 1000.0
    idle_kwh = idle_w * (1 - duty) * HOURS_PER_YEAR / 1000.0
    return CarbonReport(
        workload=workload, npu=npu.name, policy=policy,
        operational_kg_per_year=busy_kwh * PUE * CARBON_INTENSITY,
        idle_kg_per_year=idle_kwh * PUE * CARBON_INTENSITY)


@dataclass(frozen=True)
class FleetRollup:
    """Fleet-level energy accounting for one policy over one scenario
    window: chip joules → facility kWh (×PUE) → kgCO2e and USD."""
    chip_j: float           # sum of per-chip energies (busy + idle)
    chip_kwh: float         # the same energy in kWh (no PUE)
    facility_kwh: float     # at the meter: chip_kwh x PUE
    co2_kg: float           # facility_kwh x CARBON_INTENSITY
    cost_usd: float         # facility_kwh x USD_PER_KWH


def fleet_rollup(total_chip_j: float, *, pue: float = PUE,
                 carbon_intensity: float = CARBON_INTENSITY,
                 usd_per_kwh: float = USD_PER_KWH) -> FleetRollup:
    """Roll a fleet's summed per-chip joules up to facility-level
    kWh / operational CO2 / electricity cost (the fleet plane).

    The input is the exact sum of per-chip energies the fleet simulator
    accumulated (busy invocation energy + idle/gated-idle energy across
    every chip and epoch); the roll-up is pure arithmetic on that sum,
    so fleet reports reconcile with their per-record energies to float
    round-off (the ≤1e-9 acceptance bound). Embodied carbon is out of
    scope here — ``optimal_lifespan`` covers it.
    """
    if not (math.isfinite(total_chip_j) and total_chip_j >= 0):
        raise ValueError(
            f"total_chip_j must be finite and >= 0, got {total_chip_j}")
    chip_kwh = joules_to_kwh(total_chip_j)
    facility_kwh = chip_kwh * pue
    return FleetRollup(
        chip_j=total_chip_j, chip_kwh=chip_kwh,
        facility_kwh=facility_kwh,
        co2_kg=facility_kwh * carbon_intensity,
        cost_usd=facility_kwh * usd_per_kwh)


def optimal_lifespan(per_year_kg_gen0: float, *, horizon_years: int = 10,
                     efficiency_ratio: float = None,
                     embodied_kg: float = EMBODIED_KG["NPU-D"],
                     max_lifespan: int = 10) -> dict[int, float]:
    """Total carbon over ``horizon_years`` for each candidate lifespan.

    Each upgrade buys a new generation whose operational carbon improves by
    ``efficiency_ratio`` per year (paper: the NPU-D over NPU-C per-year
    ratio). Returns {lifespan_years: total_kg}; min() gives the optimum.
    """
    if efficiency_ratio is None:
        # the paper's Fig 2 trend: newer generations are ~1.5x more
        # energy-efficient per 3-year generation at the WORKLOAD level
        # (larger HBM -> fewer chips, better nodes); chip-level TDP ratios
        # alone do not capture this, so we use the observed ~13%/yr.
        efficiency_ratio = 0.87
    out: dict[int, float] = {}
    for life in range(1, max_lifespan + 1):
        total = 0.0
        year = 0
        gen_start = 0
        while year < horizon_years:
            # chip bought at gen_start has per-year op carbon scaled by
            # the fleet-efficiency of its purchase year
            op = per_year_kg_gen0 * (efficiency_ratio ** gen_start)
            total += op
            year += 1
            if (year - gen_start) >= life and year < horizon_years:
                total += embodied_kg
                gen_start = year
        total += embodied_kg  # the initial purchase
        out[life] = total
    return out


def _d_over_c_yearly_ratio() -> float:
    """Per-year operational-carbon ratio from the NPU-C -> NPU-D
    energy-efficiency trend, measured with the simulator on the paper
    suite (the paper's own assumption for Fig 25). Falls back to the
    industry-typical ~13%/yr improvement if the simulator is unavailable."""
    try:
        from repro_torch.core.opgen import llm_workload
        from repro_torch.core.policies import evaluate
        wls = [llm_workload("llama3-8b", "train", batch=32, n_chips=4,
                            tp=4),
               llm_workload("llama3-8b", "decode", batch=8, n_chips=1)]
        ratio = 1.0
        for wl in wls:
            e_c = evaluate(wl, "NPU-C", "NoPG").total_j
            e_d = evaluate(wl, "NPU-D", "NoPG").total_j
            ratio *= (e_d / e_c) ** (1.0 / len(wls))
        years = NPUS["NPU-D"].year - NPUS["NPU-C"].year
        r = ratio ** (1.0 / years)
        return min(max(r, 0.75), 0.98)
    except Exception:  # pragma: no cover
        return 0.87
