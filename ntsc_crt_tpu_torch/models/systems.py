"""System configurations: the reference's per-system macro headers.

The port's own copy of ``ntsc_crt_tpu/models/systems.py``, field for field
(a test holds the two equal).  In the reference, a "system" (NTSC, NES,
SNES, PV-1000, VHS, ...) is a header of ~40 compile-time macros plus one
crt_modulate() implementation, selected by the CRT_SYSTEM compile switch
(crt_core.h:38-59).  The demodulator is fully system-generic
(crt_core.c:291-666); only timing/level constants and the encoder vary.
Here each system is a frozen, hashable `SystemConfig`, which keys the
port's cached tables (``lru_cache``).

Derived sample positions are computed with the same integer formulas as the
reference macros:
  - ns-based timing (NTSC crt_ntsc.h:73-93, VHS crt_ntscvhs.h:77-97,
    TEMPLATE crt_template.h:79-99, PV1K via dot clock crt_pv1k.h:64-86)
  - PPU-pixel-based timing (NES crt_nes.h:92-116, NESRGB crt_nesrgb.h:92-116,
    SNES crt_snes.h:72-96)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# chroma pattern ids (crt_ntsc.h:23-25, crt_nes.h:27-30)
CHROMA_VERTICAL = 0   # 228   cc/line
CHROMA_CHECKERED = 1  # 227.5 cc/line
CHROMA_SAWTOOTH = 2   # 227.3 cc/line

VHS_SP, VHS_LP, VHS_EP = 0, 1, 2  # crt_ntscvhs.h:102-106


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static description of one emulated video system.

    Hashable & immutable so it can key the port's cached tables; all
    fields are plain ints/strs/bools.
    """

    name: str
    kind: str                 # "rgb" (RGB input) or "nes" (PPU-index input)

    # resolution / geometry
    cc_line: int              # chroma clocks per line, x10
    cb_freq: int              # carrier freq relative to sample rate
    hres: int                 # samples per line
    vres: int                 # lines per field (262)
    top: int                  # first active line
    bot: int                  # last active line (exclusive bound in loops)
    cc_samples: int           # samples per chroma period (4 or 5)
    cc_vper: int              # vertical period of chroma phase pattern

    # sync search (demodulator)
    hsync_window: int
    vsync_window: int
    hsync_thresh: int
    vsync_thresh: int

    # derived pulse positions, in samples
    sync_beg: int
    bw_beg: int
    cb_beg: int
    bp_beg: int
    av_beg: int
    av_len: int
    lav_beg: int              # full active video incl. borders (NES family)

    cb_cycles: int            # color burst cycles (10)

    # bandlimiting (None => system has no IIR path, e.g. NES square waves)
    l_freq: Optional[int]
    y_freq: Optional[int]
    i_freq: Optional[int]
    q_freq: Optional[int]
    do_bandlimiting: bool

    # IRE levels
    white_level: int
    burst_level: int
    black_level: int
    blank_level: int
    sync_level: int

    # encoder phase parameters
    chroma_pattern: int
    hue_offset: int           # burst hue offset in degrees
    q_offset: int             # Q phase offset relative to I, degrees
    progressive: bool         # NES family: always progressive

    # VHS extras
    vhs_noise: bool = False
    vhs_mode: int = VHS_SP

    # degrees the chroma phase advances per line within the vertical period
    # (SNES/NESRGB/NES: 360/VPER=120, crt_snes.c:172; TEMPLATE: 180;
    #  PV1K: 360*2/VPER=144, crt_pv1k.c:168)
    vert_step: int = 0

    # sync/equalizing line regions of the field skeleton (SNES/template style;
    # the NTSC/VHS/PV1K skeletons hard-code equivalent ranges)
    equ_a: tuple = (0, 3)     # equalizing pulses, inclusive
    sync_region: tuple = (4, 6)
    equ_b: tuple = (7, 9)

    # SNES emits the same vsync pattern for both fields (crt_snes.c:216-218);
    # every other interlaced system switches serration offsets on odd fields
    vsync_field_dependent: bool = True
    # whether the encoder applies the interlace half-line source offset
    # (crt_ntsc.c:258; SNES and the NES family do not)
    interlace_offset: bool = True

    # ---- derived helpers ------------------------------------------------
    @property
    def input_size(self) -> int:
        return self.hres * self.vres

    @property
    def lines(self) -> int:
        return self.bot - self.top

    @property
    def burst_len(self) -> int:
        """Number of burst samples accumulated by encoder/decoder
        (crt_ntsc.c:241, crt_core.c:462)."""
        return self.cb_cycles * self.cb_freq

    def cc_phase(self, inv_phase):
        """CC_PHASE for checkered chroma (crt_ntsc.c:18-23); ints only."""
        if self.chroma_pattern == CHROMA_CHECKERED:
            return 1 - 2 * (inv_phase & 1)  # odd -> -1, even -> 1
        return 1

    def khz2l(self, khz: int) -> int:
        """kHz -> line-sample conversion (crt_core.c:272)."""
        return self.hres * (khz * 100) // self.l_freq


def _ns_timing(hres: int, fp: int, sync: int, bw: int, cb: int, bp: int, av: int):
    """ns->sample positions, exactly ns2pos (crt_ntsc.h:85-93)."""
    line = fp + sync + bw + cb + bp + av
    def pos(ns: int) -> int:
        return ns * hres // line
    hb = fp + sync + bw + cb + bp
    return dict(
        sync_beg=pos(fp),
        bw_beg=pos(fp + sync),
        cb_beg=pos(fp + sync + bw),
        bp_beg=pos(fp + sync + bw + cb),
        av_beg=pos(hb),
        lav_beg=pos(hb),
        av_len=pos(av),
    )


def _ppu_timing(hres: int):
    """PPU-pixel positions, exactly PPUpx2pos (crt_nes.h:107-116)."""
    fp, sync, bw, cb, bp, ps, lb, av, rb = 9, 25, 4, 15, 5, 1, 15, 256, 11
    line = fp + sync + bw + cb + bp + ps + lb + av + rb  # 341
    def pos(px: int) -> int:
        return px * hres // line
    hb = fp + sync + bw + cb + bp
    return dict(
        sync_beg=pos(fp),
        bw_beg=pos(fp + sync),
        cb_beg=pos(fp + sync + bw),
        bp_beg=pos(fp + sync + bw + cb),
        lav_beg=pos(hb),
        av_beg=pos(hb + ps + lb),
        av_len=pos(av),
    )


# ---------------------------------------------------------------------------
# The seven presets
# ---------------------------------------------------------------------------

NTSC = SystemConfig(
    name="NTSC", kind="rgb",
    cc_line=2275, cb_freq=4, hres=2275 * 4 // 10, vres=262, top=21, bot=261,
    cc_samples=4, cc_vper=1,
    hsync_window=8, vsync_window=8, hsync_thresh=4, vsync_thresh=94,
    **_ns_timing(910, 1500, 4700, 600, 2500, 1600, 52600),
    cb_cycles=10,
    l_freq=1431818, y_freq=420000, i_freq=150000, q_freq=55000,
    do_bandlimiting=True,
    white_level=100, burst_level=20, black_level=7, blank_level=0, sync_level=-40,
    chroma_pattern=CHROMA_CHECKERED, hue_offset=33, q_offset=-90,
    progressive=False,
)

NTSCVHS = SystemConfig(
    name="NTSCVHS", kind="rgb",
    cc_line=2275, cb_freq=4, hres=910, vres=262, top=21, bot=261,
    cc_samples=4, cc_vper=1,
    hsync_window=8, vsync_window=8, hsync_thresh=4, vsync_thresh=94,
    **_ns_timing(910, 1500, 4700, 600, 2500, 1600, 52600),
    cb_cycles=10,
    # VHS_SP bandwidths (crt_ntscvhs.h:109-113); LP/EP via dataclasses.replace
    l_freq=1431818, y_freq=300000, i_freq=62700, q_freq=62700,
    do_bandlimiting=True,
    white_level=100, burst_level=20, black_level=7, blank_level=0, sync_level=-40,
    chroma_pattern=CHROMA_CHECKERED, hue_offset=33, q_offset=-90,
    progressive=False,
    vhs_noise=True, vhs_mode=VHS_SP,
)

SNES = SystemConfig(
    name="SNES", kind="rgb",
    cc_line=2273, cb_freq=4, hres=2273 * 4 // 10, vres=262, top=15, bot=255,
    cc_samples=4, cc_vper=3,
    hsync_window=6, vsync_window=6, hsync_thresh=4, vsync_thresh=94,
    **_ppu_timing(909),
    cb_cycles=10,
    l_freq=1431818, y_freq=420000, i_freq=150000, q_freq=55000,
    do_bandlimiting=False,  # crt_snes.h:101
    white_level=100, burst_level=20, black_level=7, blank_level=0, sync_level=-40,
    chroma_pattern=CHROMA_SAWTOOTH, hue_offset=210, q_offset=-90,
    progressive=False,
    vert_step=120,
    equ_a=(0, 2), sync_region=(3, 6), equ_b=(7, 9),
    vsync_field_dependent=False, interlace_offset=False,
)

NES = SystemConfig(
    name="NES", kind="nes",
    cc_line=2273, cb_freq=4, hres=2273 * 4 // 10, vres=262, top=15, bot=255,
    cc_samples=4, cc_vper=3,
    hsync_window=6, vsync_window=6, hsync_thresh=4, vsync_thresh=94,
    **_ppu_timing(909),
    cb_cycles=10,
    l_freq=1431818, y_freq=None, i_freq=None, q_freq=None,
    do_bandlimiting=False,  # square-wave synthesis, no IIR (crt_nes.c)
    white_level=110, burst_level=30, black_level=0, blank_level=0, sync_level=-37,
    chroma_pattern=CHROMA_SAWTOOTH, hue_offset=0, q_offset=-90,
    progressive=True,
    vert_step=120,
    interlace_offset=False,
)

NESRGB = SystemConfig(
    name="NESRGB", kind="rgb",
    cc_line=2273, cb_freq=4, hres=2273 * 4 // 10, vres=262, top=15, bot=255,
    cc_samples=4, cc_vper=3,
    hsync_window=6, vsync_window=6, hsync_thresh=4, vsync_thresh=94,
    **_ppu_timing(909),
    cb_cycles=10,
    l_freq=1431818, y_freq=None, i_freq=None, q_freq=None,
    do_bandlimiting=False,  # no IIR bandlimiting (crt_nesrgb.c:147-157)
    white_level=100, burst_level=30, black_level=0, blank_level=0, sync_level=-37,
    chroma_pattern=CHROMA_SAWTOOTH, hue_offset=0, q_offset=-90,
    progressive=True,
    vert_step=120,
    interlace_offset=False,
)

# PV1K timing: DOT_ns=223, DOTx4=892 (crt_pv1k.h:64-75)
PV1K = SystemConfig(
    name="PV1K", kind="rgb",
    cc_line=2304, cb_freq=5, hres=2304 * 5 // 6, vres=262, top=21, bot=261,
    cc_samples=5, cc_vper=5,
    hsync_window=8, vsync_window=8, hsync_thresh=4, vsync_thresh=94,
    **_ns_timing(1920, 3 * 892, 3 * 892, 2 * 892, 4 * 892, 4 * 892, 55 * 892),
    cb_cycles=10,
    l_freq=1431818, y_freq=420000, i_freq=150000, q_freq=55000,
    do_bandlimiting=True,
    white_level=100, burst_level=20, black_level=7, blank_level=0, sync_level=-40,
    chroma_pattern=CHROMA_VERTICAL, hue_offset=0, q_offset=90,
    progressive=False,
    vert_step=144,
    equ_a=(7, 9), sync_region=(258, 260), equ_b=(7, 9),
)

TEMPLATE = SystemConfig(
    name="TEMPLATE", kind="rgb",
    cc_line=2275, cb_freq=4, hres=910, vres=262, top=21, bot=261,
    cc_samples=4, cc_vper=2,
    hsync_window=8, vsync_window=8, hsync_thresh=4, vsync_thresh=94,
    **_ns_timing(910, 1500, 4700, 600, 2500, 1600, 52600),
    cb_cycles=10,
    l_freq=1431818, y_freq=420000, i_freq=150000, q_freq=55000,
    do_bandlimiting=True,  # crt_template.h:105
    white_level=100, burst_level=20, black_level=7, blank_level=0, sync_level=-40,
    chroma_pattern=CHROMA_CHECKERED, hue_offset=-60, q_offset=-90,
    progressive=False,
    vert_step=180,
    equ_a=(0, 2), sync_region=(3, 6), equ_b=(7, 9),
)

# CRT_CHROMA_PATTERN=0 build (crt_ntsc.h:23-33): 228 cc/line vertical
# chroma — "this will give the 'rainbow' effect in the famous waterfall
# scene".  Different line width (912 samples) and no checkered phase flip.
NTSC_RAINBOW = dataclasses.replace(
    NTSC, name="NTSC_RAINBOW", chroma_pattern=CHROMA_VERTICAL,
    cc_line=2280, hres=2280 * 4 // 10,
    **_ns_timing(2280 * 4 // 10, 1500, 4700, 600, 2500, 1600, 52600))

# VHS tape-speed variants (crt_ntscvhs.h:102-124): same timing, narrower
# luma/chroma bandwidths for Long Play / Extended Play
NTSCVHS_LP = dataclasses.replace(
    NTSCVHS, name="NTSCVHS_LP", vhs_mode=VHS_LP,
    y_freq=240000, i_freq=40000, q_freq=40000)
NTSCVHS_EP = dataclasses.replace(
    NTSCVHS, name="NTSCVHS_EP", vhs_mode=VHS_EP,
    y_freq=200000, i_freq=37000, q_freq=37000)

SYSTEMS = {
    "NTSC": NTSC,
    "NES": NES,
    "PV1K": PV1K,
    "SNES": SNES,
    "TEMPLATE": TEMPLATE,
    "NTSCVHS": NTSCVHS,
    "NESRGB": NESRGB,
    "NTSCVHS_LP": NTSCVHS_LP,
    "NTSCVHS_EP": NTSCVHS_EP,
    "NTSC_RAINBOW": NTSC_RAINBOW,
}

# reference CRT_SYSTEM ids (crt_core.h:30-36) for the oracle bridge
SYSTEM_IDS = {
    "NTSC": 0, "NES": 1, "PV1K": 2, "SNES": 3, "TEMPLATE": 4,
    "NTSCVHS": 5, "NESRGB": 6,
}
