"""The control of the check that decides ``correct``: the plain reference
put in the program's place, its decoder's 3-band EQ marched in float32
without the truncations the configurations state (every output byte
bit-exact).  It drives a cell's own traffic at the cell's own size and
must come out not correct on every seed:

    python3 crt_bench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

Each seed prints one JSON line: the seed, ``correct`` and the numbers
compared.  Slow: the reference is plain torch.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from crt_bench.reference import pipeline as ref  # noqa: E402
from crt_bench.reference import systems as ref_systems  # noqa: E402
from crt_bench.reference.demodulate import MonitorParams  # noqa: E402


def _one(state: ref.CRTState) -> ref.CRTState:
    return ref.CRTState(*(x[0] for x in state))


def _lift(state: ref.CRTState) -> ref.CRTState:
    return ref.CRTState(*(x[None] for x in state))


class Session:
    """LiveSession's tick on the control: fade, step, the frame to the
    host, the knobs of the live loop."""

    def __init__(self, cfg, outw: int, outh: int, device, noise: int = 0,
                 **knobs):
        self.cfg, self.noise, self.n = cfg, noise, 0
        self.state = _one(ref.init_slots(cfg, [0], outw, outh, device))

    def tick(self, img):
        field, frame, dco = ref.live_knobs(self.cfg, self.n)
        st = _lift(self.state)
        st = st._replace(out=ref.fade_phosphors(st.out))
        img = torch.as_tensor(img, device=st.out.device)[None]
        self.state = _one(ref.step(
            self.cfg, st, img, field=field, frame=frame,
            dot_crawl_offset=dco, noise=self.noise, mon=MonitorParams(),
            eq_float=True))
        self.n += 1
        return self.state.out.cpu().numpy()


class Control:
    """The system-under-test interface of program.Port, on the reference
    with eq_float."""

    def __init__(self):
        self._video_n = 0

    def system(self, name: str):
        return ref_systems.SYSTEMS[name]

    def monitor(self, **knobs):
        return MonitorParams(**knobs)

    def init_batch(self, cfg, batch: int, outw: int, outh: int, device):
        return ref.init_slots(cfg, range(batch), outw, outh, device)

    def crt_init(self, cfg, outw: int, outh: int, device):
        return _one(ref.init_slots(cfg, [0], outw, outh, device))

    def step_batch(self, cfg, states, imgs, fields, frames, dcos, *,
                   noise=0, mon=None, do_aberration=0):
        return ref.step(cfg, states, imgs, field=fields, frame=frames,
                        dot_crawl_offset=dcos, noise=noise, mon=mon,
                        do_aberration=do_aberration, eq_float=True)

    def video_exact(self, cfg, state, frames, *, noise=0, mon=None,
                    do_aberration=0):
        st, outs = _lift(state), []
        for img in frames:
            field, frame = ref.converter_parity(self._video_n,
                                                cfg.progressive)
            st = ref.step(cfg, st, img[None], field=field, frame=frame,
                          dot_crawl_offset=self._video_n % max(cfg.cc_vper,
                                                               1),
                          noise=noise, mon=mon, do_aberration=do_aberration,
                          eq_float=True)
            outs.append(st.out[0])
            self._video_n += 1
        return _one(st), torch.stack(outs)

    def live_session(self, cfg, outw: int, outh: int, device, **knobs):
        return Session(cfg, outw, outh, device, **knobs)

    def span_targets(self) -> dict:
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from crt_bench import harness
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               torch.device(args.device), time.perf_counter(),
                               sut=Control())
        print(json.dumps(dict(seed=seed, correct=res["correct"],
                              failed=res["failed"], checks=res["checks"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
