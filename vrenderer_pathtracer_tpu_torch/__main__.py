from vrenderer_pathtracer_tpu_torch.cli import main

raise SystemExit(main())
