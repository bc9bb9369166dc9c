// The reach closure with its stage clocks on: csrc/reach_closure.cu built
// with SHK_STAGE_CLOCKS, so that each level stamps its stages into the
// `clocks` array (stage_clock.cuh) for tools/closure_stages.py. Measurement
// only; the program loads the build of reach_closure.cu itself.

#define SHK_STAGE_CLOCKS 1
#include "reach_closure.cu"
