"""Restart-resilient training (counterpart of ``tools/train_chunked.sh``).

    python -m bonai_tpu_torch.tools.train_chunked CONFIG WORK_DIR \\
        [python -m bonai_tpu_torch.tools.train args ...]

Runs ``python -m bonai_tpu_torch.tools.train CONFIG --work-dir WORK_DIR``
with the extra arguments, resuming from the newest checkpoint in
``WORK_DIR`` (``engine.checkpoint.latest_checkpoint``), at most 40 times:
it starts again only when the run exits with 75 (the host-RSS watchdog's
clean checkpoint-and-exit), prints ``complete`` and exits 0 when a run
exits 0, and exits with any other code a run ends with.  The extra
arguments go to every attempt, so ``--n-devices N`` trains data-parallel
throughout: the train CLI exits 75 when its ranks did, each resumed rank
takes its own sampler state from the checkpoint.

It is Python rather than a shell script so that it finds the newest
checkpoint with the package's own function in-process and runs wherever
the package does.  Each attempt is a fresh process, so whatever host
memory the last one held is returned before the next starts; the JAX
wrapper's 10 s pause between attempts (for the TPU to release its claim)
has no counterpart on a GPU.
"""

from __future__ import annotations

import subprocess
import sys

from ..engine.checkpoint import latest_checkpoint

MAX_ATTEMPTS = 40
RSS_EXIT = 75


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        raise SystemExit("usage: python -m bonai_tpu_torch.tools."
                         "train_chunked CONFIG WORK_DIR [train args ...]")
    config, work_dir, extra = argv[0], argv[1], argv[2:]
    for attempt in range(1, MAX_ATTEMPTS + 1):
        latest = latest_checkpoint(work_dir)
        resume = ["--resume-from", latest] if latest else []
        print(f"[train_chunked] attempt {attempt} resume="
              f"'{latest or 'none'}'", flush=True)
        rc = subprocess.call([sys.executable, "-u", "-m",
                              "bonai_tpu_torch.tools.train", config,
                              "--work-dir", work_dir, *resume, *extra])
        if rc == 0:
            print("[train_chunked] complete", flush=True)
            return 0
        if rc != RSS_EXIT:
            print(f"[train_chunked] failed rc={rc}", flush=True)
            return rc if rc > 0 else 128 - rc     # killed by signal -rc
        print(f"[train_chunked] RSS-limit restart (rc={RSS_EXIT})",
              flush=True)
    print("[train_chunked] too many restarts", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
