"""BP vs BP+OSD-0 comparison (the degeneracyCount notebook, as a sweep).

    python -m qldpc_tpu_torch.examples.degeneracy_count [--device cpu] [--trials N]

Port of examples/degeneracy_count.py: runs both decoders over the full code
list at one error rate and prints the LER / degeneracy comparison table the
notebook plots.
"""

import argparse

from qldpc_tpu_torch.codes import BB_CODE_NAMES, get_code
from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
from qldpc_tpu_torch.mc.engine import engine_device


def run(trials: int = 2000, p: float = 0.050119, device="cuda",
        bp: BPConfig = BPConfig(max_iter=50)) -> dict:
    """Each code's counters under BP alone and BP + OSD-0 (BP(50)
    sum-product unless ``bp`` says otherwise), batch 1,000, seed 7:
    ``{(code, "bp" or "bposd"): counters_to_dict(...)}``."""
    out = {}
    for name in BB_CODE_NAMES:
        code = get_code(name)
        for label, osd in (("bp", None), ("bposd", OSDConfig(order=0))):
            eng = MonteCarloEngine(
                code,
                EngineConfig(bp=bp, osd=osd, batch_size=1000),
                device=device,
            )
            out[name, label] = counters_to_dict(eng.run_rate(p, trials=trials, seed=7))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m qldpc_tpu_torch.examples.degeneracy_count")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--trials", type=int, default=2000)
    ap.add_argument("--p", type=float, default=0.050119)
    args = ap.parse_args(argv)
    device = engine_device(args.device)
    print(f"p = {args.p}, trials = {args.trials}")
    print(f"{'code':18s} {'BP-only LER':>12s} {'BP+OSD LER':>12s} {'degenerate':>11s}")
    results = run(args.trials, args.p, device)
    for name in BB_CODE_NAMES:
        bp, bposd = results[name, "bp"], results[name, "bposd"]
        print(f"{name:18s} {bp['ler']:12.4f} {bposd['ler']:12.4f} {bposd['degeneracies']:11.4f}")


if __name__ == "__main__":
    main()
