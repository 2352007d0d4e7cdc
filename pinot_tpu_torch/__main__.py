"""``python -m pinot_tpu_torch`` -> the admin CLI (``tools/admin.py``)."""

import sys

from pinot_tpu_torch.tools.admin import main

sys.exit(main())
