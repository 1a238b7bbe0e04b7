// The kernels at one field shape of the table in ops/_build.py (SHAPES).
// _build.build compiles this unit once per table entry, each with the
// entry's flags (FieldShape.defines), so the table is the one place that
// lists the shapes:
//  * a Triplane + CP shape: -DMF_SHAPE=<name> -DMF_NS=.. -DMF_R0=..
//    -DMF_R1=.. -DMF_R2=.. -DMF_RCP=.. -DMF_CCP=..: K0-K4;
//  * a hash-grid shape: -DMF_SHAPE=<name> -DMF_HASH_L=<levels>: H1-H3, K1
//    on the embed they write, K2.
// The unit instantiates every kernel at that shape and defines its C entry
// points mf_<fn>_<name>; the loader checks their sizes against the table
// once.

#include "field.cuh"
#include "field_forward.cuh"
#include "hashgrid.cuh"
#include "triplane.cuh"

#if defined(MF_SHAPE) && defined(MF_HASH_L)

using Shape = mf::HashShape<MF_HASH_L>;

// SUFFIX is expanded here (MF_SHAPE -> its name) before the entry-point
// macros paste it onto each function's name.
#define MF_ENTRY_POINTS(SH, SUFFIX)                \
  MF_FIELD_FORWARD_EMBED_ENTRY_POINTS(SH, SUFFIX) \
  MF_DECODER_BACKWARD_ENTRY_POINTS(SH, SUFFIX)    \
  MF_HASH_ENTRY_POINTS(SH, SUFFIX)

#elif defined(MF_SHAPE) && defined(MF_NS) && defined(MF_R0) && \
    defined(MF_R1) && defined(MF_R2) && defined(MF_RCP) && defined(MF_CCP)

using Shape = mf::FieldShape<MF_NS, MF_R0, MF_R1, MF_R2, MF_RCP, MF_CCP>;

#define MF_ENTRY_POINTS(SH, SUFFIX)        \
  MF_FIELD_FORWARD_ENTRY_POINTS(SH, SUFFIX) \
  MF_DECODER_BACKWARD_ENTRY_POINTS(SH, SUFFIX) \
  MF_TRIPLANE_ENTRY_POINTS(SH, SUFFIX)

#else
#error "shape.cu is compiled once per entry of ops/_build.SHAPES, with its flags"
#endif

MF_ENTRY_POINTS(Shape, MF_SHAPE)
