"""Algorithm 1 in action: LP-based configuration search for an
SSD-offloaded training run.

    python -m repro_torch.examples.lp_config_search [--model gpt-65b]

Benchmarks (here: presets for) the machine, then searches micro-batch
count n, delay ratio α, and the CPU/SSD storage split x for checkpoints,
parameters, and optimizer states — printing the throughput landscape and
the chosen configuration, exactly the procedure of paper §4.5. This is
host-only arithmetic (no device): it takes no ``--device``.
"""
import argparse
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.lp_search import find_optimal_config, solve_config
from repro_torch.core.perfmodel import MachineParams, Workload, rooflines

MACHINES = {
    "a100-cloud": MachineParams(name="a100-cloud", gpu_flops=140e12,
                                pcie_bw=24e9, ssd_read_bw=4.0e9,
                                ssd_write_bw=2.0e9, cpu_adam_bw=8.0e9,
                                cpu_mem=400e9, gpu_mem=40e9),
    "a5000": MachineParams(name="a5000", gpu_flops=55e12, pcie_bw=24e9,
                           ssd_read_bw=6.9e9, ssd_write_bw=4.1e9,
                           cpu_adam_bw=5.0e9, cpu_mem=256e9, gpu_mem=24e9),
}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt-65b")
    ap.add_argument("--machine", default="a100-cloud", choices=MACHINES)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)

    cfg = get_config(args.model)
    m = MACHINES[args.machine]
    w = Workload.from_config(cfg, micro_batch=args.micro_batch,
                             seq_len=args.seq)
    print(f"{args.model} on {m.name}: ms={w.ms / 1e9:.0f}GB "
          f"cs={w.cs / 1e9:.2f}GB os={w.os_bytes / 1e9:.0f}GB "
          f"grads={w.grad_bytes / 1e9:.0f}GB\n")

    print("n    alpha*  t_iter(s)  tokens/s   x_ckpt x_param x_opt")
    alphas = [i / 20 for i in range(11)]
    landscape = {}
    for n in (2, 4, 8, 16, 24, 32, 48, 64):
        best = None
        for a in alphas:
            s = solve_config(m, w, n, a)
            if s and (best is None or s.iteration_time < best[1].iteration_time):
                best = (a, s)
        if best is None:
            print(f"{n:<4d} infeasible")
            landscape[n] = None
            continue
        a, s = best
        tp = n * w.tokens_per_mb / s.iteration_time
        landscape[n] = (a, s.iteration_time, tp)
        print(f"{n:<4d} {a:5.2f} {s.iteration_time:10.1f} {tp:10.1f}"
              f"   {s.x.ckpt:6.2f} {s.x.param:7.2f} {s.x.opt:5.2f}")

    res = find_optimal_config(m, w, alphas=alphas, max_n=256)
    io_roof, comp_roof = rooflines(w, m, res.x)
    print(f"\nAlgorithm 1 selects: n*={res.n} alpha*={res.alpha:.2f} "
          f"x*=(ckpt {res.x.ckpt:.2f}, param {res.x.param:.2f}, "
          f"opt {res.x.opt:.2f})")
    print(f"throughput {res.throughput_tokens_per_s:.1f} tokens/s "
          f"({100 * res.throughput_tokens_per_s / comp_roof:.0f}% of the "
          f"compute roofline)")
    return {"result": res, "landscape": landscape, "rooflines":
            (io_roof, comp_roof)}


if __name__ == "__main__":
    main()
