"""Parameter-server side of the port: row relocation for Type I-b
re-layouts (``odmr``)."""
