"""Host I/O of the port (port of ``mcrat_tpu.io``).

- :mod:`.mcpar`: mc.par parse/write (Src/mcrat_io.c:1136-1237)
- :mod:`.flash`: FLASH 2-D AMR frames (Src/mclib_flash.c)
- :mod:`.pluto`, :mod:`.pluto_chombo`: PLUTO ``.dbl``/``.h5`` frames and
  PLUTO-Chombo AMR frames (Src/mclib_pluto.c)
- :mod:`.riken`: RIKEN 2-D and 3-D frames (Src/mclib_riken.c)
- :mod:`.decimate`: the shared photon-band frame decimation
- :mod:`.hydro`: getHydroData dispatch and the spatial index
  (Src/mcrat_io.c:1898-1990)
- :mod:`.photons_h5`: per-rank photon dumps (HDF5 or npz) and their merge,
  ProcessMCRaT schema (Src/mcrat_io.c:114-836, 1239-1772; Src/merge.c)
- :mod:`.checkpoint`: checkpoint/resume/elastic restart
  (Src/mcrat_io.c:838-1134, Src/mcrat.c:166-448)
"""
