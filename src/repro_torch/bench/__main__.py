import sys

from repro_torch.bench.studies import main

sys.exit(main())
