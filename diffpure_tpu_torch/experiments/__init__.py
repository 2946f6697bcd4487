"""Validation experiments: the trained-weights defence demonstration
(``python -m diffpure_tpu_torch.experiments.defense_demo``). Its names are
loaded on first use, so that running the module does not import it twice."""
_EXPORTS = ("DemoConfig", "demo_spec", "train_demo_classifier", "train_demo_score",
            "build_demo_defended", "run_demo_protocol", "run_dose_response")


def __getattr__(name):
    if name in _EXPORTS:
        from diffpure_tpu_torch.experiments import defense_demo
        return getattr(defense_demo, name)
    raise AttributeError(name)
