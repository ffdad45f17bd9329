import sys

from ltbench.run import main

sys.exit(main())
