"""SharedDB core on PyTorch: the batched shared-computation query engine.

Layers (each the port of the ``repro.core`` module of the same name,
except ``device`` and ``graphs``):
  device      — ``device=None`` means the CUDA card; the CPU only on request
  graphs      — a fixed-buffer step captured as a CUDA graph (where the
                reference jits)
  dataquery  — the data-query model as packed query bitmasks (int32 words)
  storage     — columnar tables as tensors, dirty-row sets, key partitions
  operators   — shared join / union compression / sort / top-n / routing
  plan        — global query plan (DAG), template merging (Fig. 3)
  lowering    — plan -> staged operator graph IR and the heartbeat cycles
  backends    — operator backend registry: ``torch`` plain ops vs ``hopper``
                CUDA kernels
  executor    — pipelined dispatch/collect heartbeats on one device
  baseline    — query-at-a-time executor ("SystemX" stand-in, an oracle)
"""
