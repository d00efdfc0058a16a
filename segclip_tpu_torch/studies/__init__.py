"""Studies that load a model and write a JSON report (the JAX package's
`scripts/{classprobe,spatial_margin_probe,holdout_study,eval_ipd_study}.py`),
one module each, run as `python -m segclip_tpu_torch.studies.<name>`.

Each keeps its script's flags, model configuration and report keys, so that
the reports in docs/artifacts/ compare one to one, and adds `--device`
(default `cuda`; raises without a card; the CPU runs only when named).
"""
