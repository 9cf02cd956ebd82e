"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version (in the same module) for CPU tensors.  ``LAUNCHES`` counts
kernel launches per wrapper — incremented only where a kernel is launched
— so a run can show that the main path went through the kernels.
"""

LAUNCHES = {"mixdec": 0, "fastfir": 0, "fastfir_batch": 0, "scan_plain": 0,
            "scan_solve": 0, "smeter": 0, "seqloop_fm": 0, "seqloop_sam": 0,
            "resamp": 0, "agcseq": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
