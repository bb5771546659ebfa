from adiabatic_raytracer.cli import main

raise SystemExit(main())
