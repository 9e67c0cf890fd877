#!/bin/sh
# Run modes of the port's benchmark harness, one process each, at the JAX
# harness's defaults (knobs from the environment pass through):
#
#     tools/torch_bench_all.sh OUT_DIR [MODE ...]
#
# MODE is a BENCH_MODE value, or "default" for the mode with BENCH_MODE
# unset; without modes, every mode. Each mode's JSON line goes to
# OUT_DIR/<mode>.json and its stderr to OUT_DIR/<mode>.err; the card's name
# and power limit to OUT_DIR/card.txt. All modes run; the exit code is
# non-zero if any of them failed.
set -u
out=$1
shift
[ $# -gt 0 ] || set -- default probe multistream multistream_sharded \
    dldet_sharded yolo dldet high_mask photo denoise recheck
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    > "$out/card.txt"
status=0
for mode in "$@"; do
    start=$(date +%s)
    if [ "$mode" = default ]; then
        env -u BENCH_MODE python3 -m metdetpy_tpu_torch.bench \
            > "$out/$mode.json" 2> "$out/$mode.err"
    else
        BENCH_MODE=$mode python3 -m metdetpy_tpu_torch.bench \
            > "$out/$mode.json" 2> "$out/$mode.err"
    fi
    rc=$?
    echo "$mode: exit $rc, $(( $(date +%s) - start )) s"
    [ $rc -eq 0 ] || { status=1; tail -n 20 "$out/$mode.err"; }
done
cat "$out/card.txt" "$out"/*.json
exit $status
