"""Host I/O of the port (port of ``mcrat_tpu.io``): the FLASH AMR reader
(:mod:`.flash`), the shared photon-band decimation (:mod:`.decimate`) and
the spatial-index dispatch (:mod:`.hydro`)."""
