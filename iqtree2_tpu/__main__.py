from iqtree2_tpu.cli import main

raise SystemExit(main())
