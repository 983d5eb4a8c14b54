"""CORE's serving stack: the continuous-batching ``CascadeServer`` with its
drift-adaptive loop (``engine``), its streaming statistics (``stats``), the
SLO-aware request front end (``frontend``) and the multi-query session
engine (``multiquery``).  Submit-time scoring runs on the card through the
``cascade_score`` kernel (``kernels/ops.py::CascadeScorer``)."""
