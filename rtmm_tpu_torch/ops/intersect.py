"""Möller-Trumbore acceptance constants (intersection.hlsl).

Only the constants travel in this slice: the per-ray intersection routines
of the JAX package's ops/intersect.py serve the per-ray reference backend,
which is not ported yet.
"""
MT_UV_EPS = 1e-3        # intersection.hlsl:413
MT_DET_EPS = 1e-8       # intersection.hlsl:423
