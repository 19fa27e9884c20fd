"""NPU hardware specifications (paper Table 2) and power-gating circuit
parameters (paper Table 3). These are simulation *inputs* — the chips the
simulator models — not the device the simulator runs on.

NPU-A/B/C/D derive from TPUv2/3/4/5p; NPU-E is the projected generation.
Parameters marked inferred in the paper are reproduced as published.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class GatingParams:
    """Per-component power-gating circuit parameters (paper Table 3)."""

    on_off_delay: dict[str, int] = field(default_factory=lambda: {
        "sa_pe": 1, "sa_full": 10, "vu": 2, "hbm": 60, "ici": 60,
        "sram_sleep": 4, "sram_off": 10,
    })
    bet: dict[str, int] = field(default_factory=lambda: {
        "sa_pe": 47, "sa_full": 469, "vu": 32, "hbm": 412, "ici": 459,
        "sram_sleep": 41, "sram_off": 82,
    })
    # leakage power in gated state, as a fraction of active-state static
    # power (paper §6.1 defaults; varied in the sensitivity analysis)
    leak_off_logic: float = 0.03
    leak_sram_sleep: float = 0.25
    leak_sram_off: float = 0.002
    # HBM low-power auto-refresh: PHY standby + DRAM refresh keep burning
    leak_hbm_refresh: float = 0.25
    # VU fine-grained duty pattern: burst length while draining SA output
    vu_burst_cycles: int = 16
    # PE W_on mode: only the weight register powered (our synthesis estimate)
    leak_pe_weight_on: float = 0.15
    detection_window_frac: float = 1 / 3  # idle-detection window = BET/3


@dataclass(frozen=True)
class NPUSpec:
    name: str
    year: int
    tech_nm: int
    freq_mhz: int
    sa_width: int
    n_sa: int
    n_vu: int
    sram_mb: int
    hbm_gbps: float
    hbm_gb: int
    ici_gbps_link: float
    ici_links: int
    # chip power envelope (W). idle_w/tdp_w for A/B validated against
    # published TPUv2/v3 data (paper §4.4: within 9%/5%); C from TPUv4i
    # literature; D/E inferred/projected (*).
    idle_w: float = 60.0
    tdp_w: float = 250.0
    # share of busy-chip energy that is static at typical utilization —
    # rises with newer nodes (paper Fig 3: 30–72%)
    static_frac_busy: float = 0.45
    gating: GatingParams = field(default_factory=GatingParams)

    # ---------- derived ----------
    @property
    def freq_hz(self) -> float:
        return self.freq_mhz * 1e6

    @property
    def sa_flops(self) -> float:
        """Peak MatMul FLOP/s (MAC = 2 FLOPs). Derivation reproduces the
        published peaks: A=46T, B=123T, C=275T, D=459T."""
        return self.sa_width ** 2 * 2 * self.n_sa * self.freq_hz

    @property
    def vu_flops(self) -> float:
        """Peak vector FLOP/s: 8x128 SIMD lanes x 2 (FMA) per VU."""
        return self.n_vu * 8 * 128 * 2 * self.freq_hz

    @property
    def hbm_bw(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def ici_bw(self) -> float:
        return self.ici_gbps_link * self.ici_links * 1e9

    @property
    def sram_bytes(self) -> int:
        return self.sram_mb * 2 ** 20

    @property
    def sram_segments(self) -> int:
        return self.sram_bytes // SRAM_SEGMENT_BYTES

    def cycles(self, seconds: float) -> float:
        return seconds * self.freq_hz


SRAM_SEGMENT_BYTES = 4 * 1024  # paper: segment size == vector register size

NPUS: dict[str, NPUSpec] = {
    s.name: s for s in [
        NPUSpec("NPU-A", 2017, 16, 700, 128, 2, 4, 32, 600, 16, 62, 4,
                idle_w=53, tdp_w=280, static_frac_busy=0.30),
        NPUSpec("NPU-B", 2018, 16, 940, 128, 4, 4, 32, 900, 32, 70, 4,
                idle_w=84, tdp_w=450, static_frac_busy=0.33),
        NPUSpec("NPU-C", 2020, 7, 1050, 128, 8, 4, 128, 1200, 32, 50, 6,
                idle_w=55, tdp_w=192, static_frac_busy=0.48),
        NPUSpec("NPU-D", 2023, 7, 1750, 128, 8, 6, 128, 2765, 95, 100, 6,
                idle_w=90, tdp_w=500, static_frac_busy=0.52),
        NPUSpec("NPU-E", 2026, 4, 2000, 256, 8, 8, 256, 7400, 192, 150, 6,
                idle_w=130, tdp_w=700, static_frac_busy=0.60),
    ]
}


def get_npu(name: str) -> NPUSpec:
    if name in NPUS:
        return NPUS[name]
    short = f"NPU-{name[-1].upper()}"
    if short in NPUS:
        return NPUS[short]
    raise KeyError(f"unknown NPU {name!r}; have {sorted(NPUS)}")


# SA-width variants memoized by (base spec identity, width): the policy
# engine's derived-trace caches (``trace_times``, ``_host_columns``,
# ``_backend_data``) are keyed by spec identity, so the knob axis must
# hand back the SAME variant object on every call or each sweep would
# re-derive and re-transfer its arrays. The value keeps a strong ref to
# the base spec so its id cannot be reused. The variant keeps the base
# *name* — every name-keyed table (power shares, figures) applies
# unchanged, and sweep records carry the width in their own
# ``sa_width`` knob column instead of a mangled spec name.
_SAW_VARIANTS: dict[tuple[int, int], tuple["NPUSpec", "NPUSpec"]] = {}


def with_sa_width(spec: "NPUSpec", width: "int | None") -> "NPUSpec":
    """``spec`` with its systolic-array width replaced (memoized).

    ``None`` or the native width returns ``spec`` itself. Note
    ``sa_flops`` is *derived* (saw² · 2 · n_sa · freq), so widening the
    array also raises peak matmul throughput, exactly like a real
    generation variant would."""
    if width is None or width == spec.sa_width:
        return spec
    hit = _SAW_VARIANTS.get((id(spec), width))
    if hit is not None and hit[0] is spec:
        return hit[1]
    from dataclasses import replace
    var = replace(spec, sa_width=int(width))
    _SAW_VARIANTS[(id(spec), width)] = (spec, var)
    return var


@dataclass(frozen=True)
class RooflineTarget:
    """The device a roofline is drawn for: its peak dense matmul rate,
    memory rate and capacity, and its links to the other devices of a
    mesh (``ici_bw_link`` bytes/s a link, ``ici_links`` links used at
    once). Field names are the JAX package's ``RooflineTarget``'s, so a
    report reads either."""
    name: str
    peak_flops: float
    hbm_bw: float
    hbm_gb: float
    ici_bw_link: float
    ici_links: int = 1


#: the NVIDIA H100 SXM's public figures: 989 TFLOP/s dense bf16, 3.35 TB/s
#: HBM3, 80 GB, and NVLink 4's 900 GB/s taken as one link
H100_SXM = RooflineTarget(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                          hbm_gb=80.0, ici_bw_link=900e9, ici_links=1)
TARGET = H100_SXM

