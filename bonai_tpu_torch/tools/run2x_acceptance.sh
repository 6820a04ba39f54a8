#!/usr/bin/env bash
# The 2x synthetic recipe trained, tested, scored and profiled on one GPU
# through the port's own CLIs.  From the repository root:
#
#   bonai_tpu_torch/tools/run2x_acceptance.sh [OUT] [train args ...]
#
# 1. generates the acceptance set in data/synth_bonai (the arguments of
#    tools/make_synth_data.sh: 800 train tiles of 1024^2, 40 val scenes of
#    2048^2 cut into 160 crops, seed 0);
# 2. trains configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py through
#    train_chunked (process loader, a checkpoint every epoch, the newest
#    three kept) into build/run2x/wd; extra arguments go to the train CLI
#    (e.g. --seed 1);
# 3. tests the final checkpoint on the 160 val crops (bonai_test, --city
#    config) into build/run2x/r.pkl (copied to OUT when under 40 MB);
# 4. scores it per crop and merged into the scenes (bonai_evaluation, the
#    two side by side), writing the eval CSVs, their logs and the merged
#    predictions (OUT/merged_{roof,footprint}.csv);
# 5. profiles serving with the trained weights (profile_serve
#    --checkpoint).
# OUT (build/run2x/record by default) also gets train_log.jsonl, the
# train CLI's log files, each step's start and end (steps.log) and, every
# 60 s while it trains, the card's memory in use and the RSS of every
# process of the run as pid:GB (sampler.log).
set -euo pipefail
OUT=${1:-build/run2x/record}
[ $# -gt 0 ] && shift
CONFIG=configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py
WD=build/run2x/wd
PKL=build/run2x/r.pkl
mkdir -p "$OUT"
rm -rf "$WD"
stamp() { echo "$(date +%s.%N) $*" | tee -a "$OUT/steps.log"; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$OUT/card.txt"

stamp generate start
python -m bonai_tpu_torch.tools.make_synthetic_bonai --out data/synth_bonai \
    --train 800 --val-scenes 40 --size 1024 --seed 0 > "$OUT/generate.log"
stamp generate end

sample() {
    while :; do
        echo "$(date +%s) gpu_mem_used_mib=$(nvidia-smi \
            --query-gpu=memory.used --format=csv,noheader,nounits) rss_gb=$(
            ps -eo pid=,rss=,args= | awk '/tools[.]train / {
                printf "%s:%.2f,", $1, $2 / 1e6}')"
        sleep 60
    done
}
sample > "$OUT/sampler.log" &
SAMPLER=$!
trap 'kill $SAMPLER 2>/dev/null || true' EXIT
stamp train start
python -u -m bonai_tpu_torch.tools.train_chunked "$CONFIG" "$WD" \
    --options data.loader_mode=process checkpoint_config.interval=1 \
    checkpoint_config.max_keep_ckpts=3 "$@" 2>&1 \
    | tee "$OUT/train_chunked.log" | grep "^\[train_chunked\]" || true
stamp train end
kill $SAMPLER 2>/dev/null || true
tail -1 "$OUT/train_chunked.log" | grep -q "complete"
cp "$WD"/train_log.jsonl "$WD"/*.log "$OUT"/

CKPT=$(python -c "import sys; from bonai_tpu_torch.engine import \
latest_checkpoint; print(latest_checkpoint(sys.argv[1]))" "$WD")
stamp test start
python -m bonai_tpu_torch.tools.bonai_test "$CONFIG" "$CKPT" \
    --out "$PKL" --city config > "$OUT/test.log" 2>&1
stamp test end
[ "$(stat -c %s "$PKL")" -lt 40000000 ] && cp "$PKL" "$OUT"/

stamp score start
(python -m bonai_tpu_torch.tools.bonai_evaluation "$PKL" \
    --gt-json data/synth_bonai/val/val.json \
    --out-csv "$OUT/eval_percrop.csv" > "$OUT/eval_percrop.log" 2>&1
 stamp score per-crop end) &
PERCROP=$!
python -m bonai_tpu_torch.tools.bonai_evaluation "$PKL" --merge \
    --gt-json data/synth_bonai/val_originals/val_originals.json \
    --csv-prefix "$OUT/merged" --out-csv "$OUT/eval_merged.csv" \
    > "$OUT/eval_merged.log" 2>&1
stamp score merged end
wait $PERCROP

stamp profile start
python -m bonai_tpu_torch.tools.profile_serve --checkpoint "$CKPT" \
    > "$OUT/profile_serve.log" 2>&1
stamp profile end
cat "$OUT"/eval_*.log
