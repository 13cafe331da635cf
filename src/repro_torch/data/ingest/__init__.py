"""Dataset ingestion: the IDX codec, encodings, registry and mirror.

Counterpart of ``repro/data/ingest/`` for the IDX kinds:

* :mod:`~repro_torch.data.ingest.idx` — the MNIST-family IDX codec
  (a numpy-only copy of the reference's, byte for byte);
* :mod:`~repro_torch.data.ingest.encode` — booleanize / thermometer /
  quantile encodings on tensors;
* :mod:`~repro_torch.data.ingest.registry` — ``load(name, data_dir)``
  for every flavour, the single source of truth for dataset names;
* :mod:`~repro_torch.data.ingest.mirror` — the offline mirror that
  writes IDX files from the synthetic generators;
* :mod:`~repro_torch.data.ingest.natural` — the Pool → ClientData
  dispatch.

The LEAF reader and mirror, ``partition_writers``, ``fetch`` and the
streaming pool are ROADMAP item A7.
"""
