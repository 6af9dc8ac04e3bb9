"""Launch entry points and their parts: `serve.py` (the LM serving engine
and the DSE service), `train.py` (the training driver, on a mesh),
`mesh.py` (`DeviceMesh` construction), `specs.py` (meta-device input
specs), `steps.py` (the sharded train / prefill / decode step builders),
`roofline.py` (roofline terms and the DTensor cost counters),
`dryrun.py` (production-mesh dry-run on a fake process group) and
`report.py` (its tables)."""
