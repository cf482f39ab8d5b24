"""setup_s: seconds from the process's start to the first timed
alignment: torch, the CUDA context, the kernel and host libraries, the
warm-up alignment and the first input."""


def read(rec):
    return rec["setup_s"]
