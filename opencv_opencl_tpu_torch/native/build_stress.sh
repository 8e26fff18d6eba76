#!/bin/sh
# Build and run the native runtime stress harness under ThreadSanitizer,
# then under AddressSanitizer (leaks + memory errors).
#
#   sh build_stress.sh [OUT_DIR]
#
# The two binaries go to OUT_DIR (default: the package's git-ignored
# _build/stress/), never to a path another build shares.
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
OUT=${1:-$HERE/../_build/stress}
mkdir -p "$OUT"
g++ -O1 -g -std=c++17 -fsanitize=thread -pthread \
    "$HERE/framepipe_stress.cpp" -o "$OUT/framepipe_stress_tsan"
TSAN_OPTIONS="halt_on_error=1" "$OUT/framepipe_stress_tsan"
echo "TSAN: no data races detected"
g++ -O1 -g -std=c++17 -fsanitize=address,undefined -pthread \
    "$HERE/framepipe_stress.cpp" -o "$OUT/framepipe_stress_asan"
ASAN_OPTIONS="detect_leaks=1:halt_on_error=1" "$OUT/framepipe_stress_asan"
echo "ASAN/UBSAN: clean"
