"""Observability, the part the serving plane uses: phase spans
(:mod:`.tracer`) and JSONL events (:mod:`.events`).  Counterpart of a
part of ``repro/fl/obs``; the round recorder, run manifest and the
summarizer come with a later slice (ROADMAP.md, queue A)."""
