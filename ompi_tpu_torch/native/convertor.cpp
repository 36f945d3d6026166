// Native datatype pack/unpack: runs-based gather/scatter.
//
// Reference analog: opal/datatype/opal_pack_general.c — the tight C
// loops walking a datatype's contiguous runs. The Python engine
// materializes an int64 byte-index array (8x the payload) and fancy-
// indexes; this walks the (offset, length) runs per element with plain
// memcpy — no index materialization, sequential writes of the packed
// stream.
//
// Contract (ctypes, see core/convertor.py and native/__init__.py):
//   run_off/run_len: the datatype's coalesced per-element byte runs
//   count elements, each spanning `extent` source bytes
//   pack:   src (typed layout)  -> dst (dense stream)
//   unpack: src (dense stream)  -> dst (typed layout)

#include <cstdint>
#include <cstring>

extern "C" {

void ompi_tpu_pack_runs(const uint8_t* src, uint8_t* dst,
                        const int64_t* run_off, const int64_t* run_len,
                        int64_t n_runs, int64_t count, int64_t extent) {
    uint8_t* out = dst;
    for (int64_t e = 0; e < count; ++e) {
        const uint8_t* base = src + e * extent;
        for (int64_t r = 0; r < n_runs; ++r) {
            std::memcpy(out, base + run_off[r],
                        static_cast<size_t>(run_len[r]));
            out += run_len[r];
        }
    }
}

void ompi_tpu_unpack_runs(const uint8_t* src, uint8_t* dst,
                          const int64_t* run_off, const int64_t* run_len,
                          int64_t n_runs, int64_t count, int64_t extent) {
    const uint8_t* in = src;
    for (int64_t e = 0; e < count; ++e) {
        uint8_t* base = dst + e * extent;
        for (int64_t r = 0; r < n_runs; ++r) {
            std::memcpy(base + run_off[r], in,
                        static_cast<size_t>(run_len[r]));
            in += run_len[r];
        }
    }
}

}  // extern "C"
