import sys

from .iterative import main

sys.exit(main())
