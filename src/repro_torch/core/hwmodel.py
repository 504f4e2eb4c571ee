"""The paper's hardware numbers (Fig 5, Supplementary) and derived models.

These constants are transcribed from the paper.  The JAX package's
benchmarks read them for (a) the Fig 5 tables, (b) the critical-path
composition model (Fig 5c), and (c) calibration of the discrete-event
scheduler's load/switch times; no module of this package calls them
yet (the counterparts of those benchmarks are not ported).

Nothing here executes on device — it is the calibrated analytic model that
replaces SPICE/VTR.  Standard library only; the values are the JAX
package's, so both packages' models agree.
"""
from __future__ import annotations


# ---------------------------------------------------------------------------
# Fig 5(a): area (lambda^2) — layouts drawn with lambda design rules
# ---------------------------------------------------------------------------

AREA_LAMBDA2 = {
    "CB": {
        "sram_1cfg": 1298.0,
        "fefet_1cfg": 110.0,
        "fefet_2cfg": 375.0,
        "fefet_chen42_1cfg": 473.0,     # prior FeFET work [ref 42]
    },
    "LUT": {
        "sram_1cfg": 972.0,
        "fefet_1cfg": 180.0,
        "fefet_2cfg": 360.0,
        "fefet_chen42_1cfg": 352.0,
    },
}

# paper-stated area ratios (% of SRAM single-config) — validation targets
AREA_RATIO_CLAIMS = {
    ("CB", "fefet_1cfg"): 0.085,
    ("CB", "fefet_2cfg"): 0.289,
    ("CB", "fefet_chen42_1cfg"): 0.364,
    ("LUT", "fefet_1cfg"): 0.185,
    ("LUT", "fefet_2cfg"): 0.370,
    ("LUT", "fefet_chen42_1cfg"): 0.362,
}

# headline reductions for the dual-config design (abstract): LUT 63.0 %,
# CB 71.1 % area reduction vs SRAM
HEADLINE_AREA_REDUCTION = {"LUT": 0.630, "CB": 0.711}

# ---------------------------------------------------------------------------
# Fig 5(b): primitive delay / power (HSPICE, 45 nm PTM + calibrated FeFET)
# Values stated in the text; others encoded as paper-stated ratios.
# ---------------------------------------------------------------------------

LUT_READ_DELAY_PS = {
    # SRAM and FeFET-2cfg LUT delays are not stated numerically; they are
    # CALIBRATED (bisection over the Fig 5c composition model) so the
    # published average critical-path deltas (-8.6 % / +9.6 %) come out
    # exactly — see tests/test_hwmodel.py.  Orderings stated in the text
    # (FeFET-1cfg second-best NV; FeFET-2cfg < RRAM; RRAM slowest) hold.
    "sram_1cfg": 153.4,           # calibrated (pass-gate mux tree + buffer)
    "fefet_1cfg": 124.3,          # stated: 124.3 ps for 6-input LUT
    "fefet_2cfg": 155.1,          # calibrated (+ config-select mux stage)
    "rram_1cfg": 165.0,           # longest latency among NV LUTs (stated)
    "mtj_1cfg": 118.0,            # best NV latency (FeFET stated 2nd best)
}

LUT_READ_POWER_UW = {
    "fefet_1cfg": 13.1,           # stated: 13.1 uW, smallest of all
    "fefet_2cfg": 14.8,           # "increases slightly, < MTJ 1cfg"
    "mtj_1cfg": 16.0,
    "sram_1cfg": 15.2,
    "rram_1cfg": 15.6,
}

CB_DELAY_PS = {
    "sram_1cfg": 3.9,
    "fefet_1cfg": 7.8,            # stated: ~2x SRAM CB; 7.8 ps simulated
    "fefet_2cfg": 7.8,            # same branch structure (series enable FET)
}

# power ratios vs SRAM CB (stated: ~95 % / ~85 % less power)
CB_POWER_VS_SRAM = {"fefet_1cfg": 0.05, "fefet_2cfg": 0.15, "sram_1cfg": 1.0}
SB_POWER_REDUCTION = {"fefet_vs_sram": 0.536}     # abstract: 53.6 % SB power cut
CB_POWER_REDUCTION = {"fefet_vs_sram": 0.827}     # abstract: 82.7 % CB power cut

# ---------------------------------------------------------------------------
# Fig 5(c): critical-path composition model over the 7 VTR benchmarks.
#
# The paper's VTR runs show the critical path is LUT-delay dominated; the
# FeFET single-config FPGA is -8.6 % vs SRAM on average and the
# dual-config FPGA is +9.6 %.  We model the path as
#     T = a * d_LUT + b * d_CB + c * d_SB
# with per-benchmark (a, b, c) primitive counts (representative VTR-scale
# profiles), and *calibrate* the SRAM primitive delays so the published
# average deltas are met.  The per-benchmark spread is then a prediction.
# ---------------------------------------------------------------------------

VTR_BENCHMARKS = {
    #                 LUT levels, CB hops, SB hops  (representative profiles)
    "stereovision0": (10, 22, 14),
    "blob_merge":    (12, 26, 17),
    "sha":           (14, 30, 20),
    "spree":         (9, 20, 13),
    "boundtop":      (11, 24, 15),
    "diffeq2":       (13, 28, 18),
    "or1200":        (12, 27, 17),
}

SB_DELAY_PS = {"sram_1cfg": 5.2, "fefet_1cfg": 9.5, "fefet_2cfg": 9.5}

CRITICAL_PATH_CLAIMS = {"fefet_1cfg": -0.086, "fefet_2cfg": +0.096}


def critical_path_ps(tech: str, bench: str) -> float:
    a, b, c = VTR_BENCHMARKS[bench]
    lut = {"sram_1cfg": LUT_READ_DELAY_PS["sram_1cfg"],
           "fefet_1cfg": LUT_READ_DELAY_PS["fefet_1cfg"],
           "fefet_2cfg": LUT_READ_DELAY_PS["fefet_2cfg"],
           "rram_1cfg": LUT_READ_DELAY_PS["rram_1cfg"],
           "mtj_1cfg": LUT_READ_DELAY_PS["mtj_1cfg"]}[tech]
    cb = CB_DELAY_PS.get(tech, CB_DELAY_PS["sram_1cfg"])
    sb = SB_DELAY_PS.get(tech, SB_DELAY_PS["sram_1cfg"])
    return a * lut + b * cb + c * sb


def critical_path_delta(tech: str) -> float:
    """Average critical-path delta vs SRAM over the 7 VTR benchmarks."""
    deltas = []
    for bench in VTR_BENCHMARKS:
        t = critical_path_ps(tech, bench)
        s = critical_path_ps("sram_1cfg", bench)
        deltas.append((t - s) / s)
    return sum(deltas) / len(deltas)


# ---------------------------------------------------------------------------
# Fig 6 / S9 workload constants
# ---------------------------------------------------------------------------

ICAP_BANDWIDTH_GBPS = 3.2        # Xilinx ICAP port (paper: 3.2 Gb/s, ref 54)

# Representative bitstream sizes and Vitis-AI U250 latencies.  The paper
# treats these as measured-but-unpublished; we pick public-order-of-magnitude
# values (U250 full bitstream ~ 70 MB region-scale partials) such that the
# published saving ranges are met — see benchmarks/fig6d_case2.py.
NETWORKS = {
    #            bitstream_Mb   exec_ms per inference batch
    "resnet50":   (180.0, 19.5),
    "cnv":        (90.0, 2.1),
    "mobilenetv1": (120.0, 4.3),
}


def reconfig_time_s(bitstream_megabits: float) -> float:
    """Paper's formula: bitstream size / ICAP throughput (3.2 Gb/s)."""
    return bitstream_megabits * 1e6 / (ICAP_BANDWIDTH_GBPS * 1e9)


# The JAX package's TPU-side assumptions for its adapted engine, kept equal
# here (they are not measurements of a CUDA card): loading a context =
# weight bytes / effective host->HBM streaming bandwidth.
TPU_HOST_TO_HBM_GBPS = 25.0      # PCIe gen4-ish effective
TPU_SWITCH_SECONDS = 2e-6        # pointer swap + dispatch enqueue


def context_load_time_s(param_bytes: int,
                        gbps: float = TPU_HOST_TO_HBM_GBPS) -> float:
    return param_bytes / (gbps * 1e9)
