"""Dataset ingestion: the IDX and LEAF codecs, encodings, registry, mirror.

Counterpart of ``repro/data/ingest/``:

* :mod:`~repro_torch.data.ingest.idx` — the MNIST-family IDX codec
  (a numpy-only copy of the reference's, byte for byte);
* :mod:`~repro_torch.data.ingest.leaf` — LEAF-style per-writer JSON
  shards, their index and the per-writer reader (a numpy-only copy);
* :mod:`~repro_torch.data.ingest.encode` — booleanize / thermometer /
  quantile encodings on tensors;
* :mod:`~repro_torch.data.ingest.registry` — ``load(name, data_dir)``
  for every flavour, the single source of truth for dataset names, and
  ``load_stream``, a LEAF dataset's writer table;
* :mod:`~repro_torch.data.ingest.mirror` — the offline mirror that
  writes IDX and LEAF files from the synthetic generators;
* :mod:`~repro_torch.data.ingest.natural` — the Pool → ClientData
  dispatch and the writer-natural split;
* :mod:`~repro_torch.data.ingest.fetch` — verify-then-place of real
  archives (a standard-library copy).
"""
