// Building blocks of the convs' mma.sync kernels (their routes for inputs
// whose channels are not a multiple of 8, in fused_conv.cu and tconv.cu):
// cp.async copies into shared memory (also the Hopper convs' residual
// prefetch, conv_sm90.cuh), ldmatrix loads from 16-byte-padded rows, and
// the m16n8k16 tensor-core product with f32 accumulators, for bf16 and fp16
// operands.
//
// Fragment layouts of mma.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A 16x16 row-major: a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 8+2tig..), a3 (gid+8, 8+2tig..);
//   B 16x8 "col":      b0 (k 2tig..+1, n gid), b1 (k 8+2tig..+1, n gid);
//   C 16x8:            c0,c1 (gid, 2tig..+1), c2,c3 (gid+8, 2tig..+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // elements of row padding (16 bytes): conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
    // d += a * b: a 16x16 (row), b 16x8 (col), d 16x8 f32
    __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

template <>
struct Mma<__half> {
    __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

}  // namespace
