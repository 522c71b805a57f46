"""The JAX package's four examples, on the port: each runs as
``python -m repro_torch.examples.<name>``.

* ``quickstart`` -- MeZO against Adam on a reduced OPT-1.3B: loss
  descent and the train-state memory beyond the parameters.
* ``finetune_sst2`` -- the paper's Sec. 4.1 experiment: reduced
  RoBERTa-large fine-tuned by MeZO on synthetic SST-2, with its replay-log
  checkpoint.
* ``serve_personalized`` -- two users fine-tuned, exported as replay-log
  adapters and served from one engine.
* ``multipod_directions`` -- direction-parallel MeZO over the pod axis of
  a (pod 2, data 2, model 2) mesh of 8 gloo ranks (CPU only).

Each is split into functions that take the config, the step count, the
device and the initial parameters; ``main()`` keeps the JAX file's flow,
defaults and asserts. The first three run on the card unless given
``--device cpu``.
"""
