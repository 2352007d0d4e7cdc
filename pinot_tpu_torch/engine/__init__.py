"""Query engine: plan, staging, the fused scan kernel, executor, results.

Submodules are imported where they are used; nothing here builds or
launches a kernel at import time.
"""
