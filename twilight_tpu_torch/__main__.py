import sys

from .cli import main

if __name__ == "__main__":
    # guarded: a process started by multiprocessing's spawn method (the
    # torch profiler starts one) imports this module again
    sys.exit(main())
