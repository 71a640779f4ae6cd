"""The data pipeline's throughput (counterpart of
``tools/benchmark_processing.py``; the reference's cProfile harness):

    python -m tps_pp_tpu_torch.tools.benchmark_processing CONFIG \\
        [--n 200] [--workers 0 | --sweep 0,2,4] [--batch-size N] \\
        [--profile]

Builds the config's ``data.train`` with the port's ``build_dataset`` and
draws at least ``--n`` samples through its ``DataLoader`` (shuffled, seed
0; epochs repeat as needed), after one batch that starts the workers;
prints samples/s for each worker count. ``--profile`` prints cProfile's
25 costliest calls by cumulative time. Nothing runs on the card.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[int, float]:
    from ..config import load_config
    from ..datasets import DataLoader, build_dataset

    p = argparse.ArgumentParser(description='Data pipeline throughput')
    p.add_argument('config')
    p.add_argument('--n', type=int, default=200)
    p.add_argument('--profile', action='store_true')
    p.add_argument('--workers', type=int, default=0,
                   help='DataLoader worker processes; 0 = in-process')
    p.add_argument('--sweep', default=None,
                   help='comma-separated worker counts to compare')
    p.add_argument('--batch-size', type=int, default=None)
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    ds = build_dataset(cfg['data']['train'])
    batch = args.batch_size or cfg['data'].get('samples_per_gpu', 64)
    rates = {}

    def run_loader(workers: int):
        loader = DataLoader(ds, batch, shuffle=True, seed=0,
                            num_workers=workers)
        try:
            next(iter(loader))      # the workers start outside the timing
            t0 = time.perf_counter()
            n = epoch = 0
            while n < args.n:
                loader.set_epoch(epoch)
                for host_batch in loader:
                    n += host_batch['n_real']
                    if n >= args.n:
                        break
                epoch += 1
            dt = time.perf_counter() - t0
        finally:
            loader.close()
        rates[workers] = n / max(dt, 1e-9)
        print(f'workers={workers}: {n} samples in {dt:.2f}s -> '
              f'{rates[workers]:.1f} samples/sec')

    def run():
        counts = ([int(x) for x in args.sweep.split(',')] if args.sweep
                  else [args.workers])
        for w in counts:
            run_loader(w)

    if args.profile:
        pr = cProfile.Profile()
        pr.enable()
        run()
        pr.disable()
        pstats.Stats(pr).sort_stats('cumulative').print_stats(25)
    else:
        run()
    return rates


if __name__ == '__main__':
    main()
