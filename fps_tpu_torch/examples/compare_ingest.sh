#!/usr/bin/env bash
# Host ingest against device ingest for the port's three examples on the
# card. Each example runs twice under each ingest, in turns (host, device,
# device, host), with --profile; the "profile" event of each run gives the
# device busy ms per step, the device window and the traced host ms per step.
# The events go to OUT_DIR/<example>_<ingest>_<turn>.jsonl, the traces to a
# temporary directory that is deleted at the end.
#
#   bash fps_tpu_torch/examples/compare_ingest.sh [OUT_DIR]
#
# OUT_DIR defaults to chiprun_out/compare_ingest. Needs a CUDA device.
set -euo pipefail
out=${1:-chiprun_out/compare_ingest}
mkdir -p "$out"
traces=$(mktemp -d)
trap 'rm -rf "$traces"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

pa=(passive_aggressive --num-features 47236 --nnz 64 --num-examples 800000
    --local-batch 16384 --head-features 2048 --steps-per-chunk 7)
logreg=(logreg_ssp --num-features 1000000 --nnz 39 --dense-features 13
        --num-examples 1000000 --local-batch 16384 --sync-every 8)
mf=(mf --scale 20m --local-batch 32768 --combine mean --learning-rate 0.1)

run() {  # run TURN INGEST EXAMPLE ARGS...
    local turn=$1 ingest=$2 name=$3
    shift 3
    echo "== $name --ingest $ingest (turn $turn): $*"
    python -m "fps_tpu_torch.examples.$name" "$@" --ingest "$ingest" \
        --profile "$traces/${name}_${ingest}_$turn" \
        | tee "$out/${name}_${ingest}_$turn.jsonl" | grep '"profile"\|"done"'
}

for ex in pa logreg mf; do
    declare -n args=$ex
    run 1 host "${args[@]}"
    run 1 device "${args[@]}"
    run 2 device "${args[@]}"
    run 2 host "${args[@]}"
    unset -n args
done
