#!/bin/bash
# Device times of K1 and K1ᵇ of two checkouts on one card, in turns:
# (parent, change, change, parent) repeated, each run a fresh
# ``scripts/time_attention.py`` process whose lines go to OUT/<n>-<tag>.txt.
#
#   bash scripts/time_attention_abba.sh PARENT_DIR OUT [ROUNDS] [ARGS...]
#
# PARENT_DIR is an unpacked ``git archive`` of the older commit's
# ``lgm_tpu_torch chip_smoke.py scripts/time_attention.py tests/fixtures``
# in a directory ``.gitignore`` lists (``build/parent``); ROUNDS (default
# 5) of P C C P give 2 ROUNDS pairs; ARGS go to time_attention.py (``--only
# f32``). Run from the root of the newer checkout, on the card.
set -u
parent=$1
out=$2
rounds=${3:-5}
shift $(( $# < 3 ? $# : 3 ))
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  | tee "$out/smi.txt"
i=0
for _ in $(seq "$rounds"); do
  for who in parent change change parent; do
    i=$((i + 1))
    if [ "$who" = parent ]; then
      python3 scripts/time_attention.py --root "$parent" --tag parent "$@" \
        > "$out/$i-$who.txt" 2>&1
    else
      python3 scripts/time_attention.py --tag change "$@" \
        > "$out/$i-$who.txt" 2>&1
    fi
    echo "$i $who rc=$?"
    tail -n 1 "$out/$i-$who.txt" | cut -c1-300
  done
done
