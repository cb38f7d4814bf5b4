"""Framework integrations (port of ``determined_tpu/integrations``): hf —
transformers' causal LMs and sequence classifiers as platform trials;
haiku — the haiku slot, a module's forward as a platform Model, and its
vision trial. Neither imports its framework when the package is imported:
``hf`` imports ``transformers`` inside its constructors."""
