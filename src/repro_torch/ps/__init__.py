"""Parameter-server side of the port: the training step of a setting
(``stepfn``), gradient push compression (``compression``), the
self-tuning training loop (``trainer``), LM training as a tunable job
(``lm_job``), and row relocation for Type I-b re-layouts (``odmr``)."""
