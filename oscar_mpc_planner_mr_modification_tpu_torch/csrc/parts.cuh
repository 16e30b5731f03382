// A kernel library compiled in parts, so that nvcc builds its models side
// by side (ops/qp_cuda.py PARTS). The source is compiled TMPC_PARTS times
// with -DTMPC_PART=k: part k instantiates the models whose id % TMPC_PARTS
// is k (tmpc_ocp.cuh::with_model) and names each model's extern "C" entry
// NAME_part<k> (TMPC_ENTRY); an entry that takes no model is compiled in
// part 0 under its own name. Once more with -DTMPC_DISPATCH, the source
// defines each entry NAME, which calls the part that holds its model id
// (TMPC_DISPATCH_FN). Without TMPC_PARTS the source is the whole library,
// as the host builds compile it.

#pragma once

#define TMPC_CAT2(a, b) a##b
#define TMPC_CAT(a, b) TMPC_CAT2(a, b)

#if defined(TMPC_PARTS) && !defined(TMPC_DISPATCH)
#define TMPC_ENTRY(name) TMPC_CAT(name, TMPC_CAT(_part, TMPC_PART))
#define TMPC_PART0 (TMPC_PART == 0)
#else
#define TMPC_ENTRY(name) name
#define TMPC_PART0 1
#endif

// The entry NAME (RET NAME PARAMS) of a library in three parts: it calls
// the part whose models include MODEL (an argument in PARAMS; ARGS names
// the arguments in order). A model id of no part reaches a part that
// answers -3, as with_model does.
#define TMPC_DISPATCH_FN(RET, NAME, PARAMS, ARGS, MODEL) \
  RET NAME##_part0 PARAMS;                               \
  RET NAME##_part1 PARAMS;                               \
  RET NAME##_part2 PARAMS;                               \
  RET NAME PARAMS {                                      \
    switch (((MODEL) % 3 + 3) % 3) {                     \
      case 0:                                            \
        return NAME##_part0 ARGS;                        \
      case 1:                                            \
        return NAME##_part1 ARGS;                        \
      default:                                           \
        return NAME##_part2 ARGS;                        \
    }                                                    \
  }

#if defined(TMPC_DISPATCH)
static_assert(TMPC_PARTS == 3, "the dispatchers know three parts");
#endif
