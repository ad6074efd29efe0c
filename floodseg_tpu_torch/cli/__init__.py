"""The port's command line: ``python -m floodseg_tpu_torch.cli.main
{fit,validate,test,predict} --config X.yaml ... [--device cpu]``."""
