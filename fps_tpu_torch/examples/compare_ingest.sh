#!/usr/bin/env bash
# Host ingest against device ingest for the port's examples on the card:
# binary PA with the head prefix (pa), SGD logistic regression (logreg), MF
# (mf), 20-class PA (pa20) and AdaGrad logistic regression (adagrad), the
# last two without a head. Each example runs twice under each ingest, in
# turns (host, device, device, host), with --profile; the "profile" event
# of each run gives the device busy ms per step, the device window and the
# traced host ms per step. The events go to
# OUT_DIR/<example>_<ingest>_<turn>.jsonl, the traces to a temporary
# directory that is deleted at the end.
#
#   bash fps_tpu_torch/examples/compare_ingest.sh [OUT_DIR [EXAMPLE...]]
#
# OUT_DIR defaults to chiprun_out/compare_ingest. Needs a CUDA device.
# EXAMPLE names default to all five.
set -euo pipefail
out=${1:-chiprun_out/compare_ingest}
shift $(($# > 0 ? 1 : 0))
examples=${*:-pa logreg mf pa20 adagrad}
mkdir -p "$out"
traces=$(mktemp -d)
trap 'rm -rf "$traces"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

pa=(passive_aggressive --num-features 47236 --nnz 64 --num-examples 800000
    --local-batch 16384 --head-features 2048 --steps-per-chunk 7)
logreg=(logreg_ssp --num-features 1000000 --nnz 39 --dense-features 13
        --num-examples 1000000 --local-batch 16384 --sync-every 8)
mf=(mf --scale 20m --local-batch 32768 --combine mean --learning-rate 0.1)
pa20=(passive_aggressive --num-features 47236 --nnz 64 --num-examples 200000
      --num-classes 20 --local-batch 16384 --epochs 2 --steps-per-chunk 4)
adagrad=(logreg_ssp --num-features 1000000 --nnz 39 --dense-features 13
         --num-examples 262144 --local-batch 16384 --sync-every 8
         --optimizer adagrad --learning-rate 0.01 --epochs 2
         --steps-per-chunk 8)

run() {  # run TURN INGEST TAG MODULE ARGS...
    local turn=$1 ingest=$2 tag=$3 name=$4
    shift 4
    echo "== $tag --ingest $ingest (turn $turn): $name $*"
    python -m "fps_tpu_torch.examples.$name" "$@" --ingest "$ingest" \
        --profile "$traces/${tag}_${ingest}_$turn" \
        | tee "$out/${tag}_${ingest}_$turn.jsonl" | grep '"profile"\|"done"'
}

for ex in $examples; do
    declare -n args=$ex
    run 1 host "$ex" "${args[@]}"
    run 1 device "$ex" "${args[@]}"
    run 2 device "$ex" "${args[@]}"
    run 2 host "$ex" "${args[@]}"
    unset -n args
done
