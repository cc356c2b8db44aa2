#!/usr/bin/env bash
# The port's bench (`python -m jepsen_tpu_torch.bench`) in fresh
# processes, two checkouts in turns, so that a first check's `cold_s`
# and the warm `value` of two trees compare within one machine:
#
#   scripts/cold_ab.sh PARENT_DIR CHANGE_DIR [ROUNDS]
#
# Each checkout first runs the bench once, discarded (it builds the
# kernels into that checkout's build/torch_kernels/). Then ROUNDS
# (default 2) times: parent, change, change, parent. Prints the card's
# name and power limit, then one JSON line a run: {"tree", "turn",
# "cold_s", "value", "compiles", "verdict"}.
set -euo pipefail
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
rounds=${3:-2}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true

bench() {  # tree-name dir turn
    local out
    out=$(cd "$2" && python3 -m jepsen_tpu_torch.bench | tail -n 1)
    python3 -c '
import json, sys
b = json.loads(sys.argv[3])
print(json.dumps({"tree": sys.argv[1], "turn": int(sys.argv[2]),
                  "cold_s": b["cold_s"], "value": b["value"],
                  "compiles": b["compiles"], "verdict": b["verdict"]}))
' "$1" "$3" "$out"
}

bench parent "$parent" -1 >/dev/null
bench change "$change" -1 >/dev/null
turn=0
for _ in $(seq "$rounds"); do
    for t in parent change change parent; do
        if [ "$t" = parent ]; then d=$parent; else d=$change; fi
        bench "$t" "$d" "$turn"
        turn=$((turn + 1))
    done
done
