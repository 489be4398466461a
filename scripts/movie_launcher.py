"""Multi-process / multi-host movie orchestration (ROADMAP feature #8).

Animation frames are embarrassingly parallel (zero inter-frame
communication — reference movie.py renders them strictly serially, with a
full scene+BVH+kernel rebuild per frame).  This launcher shards frames
across K local worker processes via the movie CLI's --frame-stride /
--frame-offset flags; across HOSTS, run one launcher per host with
--hosts/--host-index and the stride factors compose.

Each worker is pinned to its own card with CUDA_VISIBLE_DEVICES: a JAX
process reserves most of every card it opens, so two workers on one card
would fail for want of memory.  The launcher refuses more workers than the
host has cards, and itself never imports JAX.

Usage:
  python scripts/movie_launcher.py --workers 4 -- --scene dragon \
      --movie-frames 120 --samples 8
  # host 1 of 2, 4 workers each:
  python scripts/movie_launcher.py --workers 4 --hosts 2 --host-index 1 \
      -- --scene dragon --movie-frames 120
"""

import argparse
import os
import subprocess
import sys


def count_cards() -> int:
    """Cards nvidia-smi lists on this host (0 without nvidia-smi)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    return len(r.stdout.split()) if r.returncode == 0 else 0


def worker_commands(workers, hosts, host_index, movie_args):
    """[(environment additions, argv)] for this host's workers: worker w
    gets card w and frames offset + k * (workers * hosts)."""
    stride = workers * hosts
    out = []
    for w in range(workers):
        offset = host_index * workers + w
        cmd = [
            sys.executable, "-m", "clive2.apps.movie",
            "--frame-stride", str(stride),
            "--frame-offset", str(offset),
        ] + [a for a in movie_args if a != "--"]
        out.append(({"CUDA_VISIBLE_DEVICES": str(w)}, cmd))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workers", type=int, default=1,
                        help="local worker processes, one card each")
    parser.add_argument("--hosts", type=int, default=1,
                        help="total hosts sharding this movie")
    parser.add_argument("--host-index", type=int, default=0)
    parser.add_argument("movie_args", nargs=argparse.REMAINDER,
                        help="arguments forwarded to clive2.apps.movie "
                        "(prefix with --)")
    args = parser.parse_args(argv)

    cards = count_cards()
    if args.workers > cards:
        parser.error(f"--workers {args.workers} exceeds the {cards} "
                     "card(s) on this host (one worker per card)")
    procs = []
    for env_add, cmd in worker_commands(args.workers, args.hosts,
                                        args.host_index, args.movie_args):
        print("launch:", env_add, " ".join(cmd), flush=True)
        procs.append(subprocess.Popen(cmd, env=dict(os.environ, **env_add)))

    rc = 0
    for p in procs:
        rc = max(rc, p.wait())
    return rc


if __name__ == "__main__":
    sys.exit(main())
