"""Faults planted under the timed path, for the checks that `correct`
must fail on them (the tests and `calibrate.py`; a benchmark run plants
none).

    alter_token      serving: every 4th token selection adds one to
                     every row's token, where the engine produces it
    half_batch       training: the loss is the mean over the first half
                     of the batch only (of the sequence, for one row)
    unchanged_state  training: the step computes its loss and gradients
                     and keeps the parameters it had
"""

EVERY = 4


def alter_token(engine):
    select, calls = engine._select, [0]

    def altered(logits):
        tok = select(logits)
        calls[0] += 1
        if calls[0] % EVERY == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    engine._select = altered


def half_batch(trainer):
    loss = trainer.loss

    def half(params, batch):
        if batch.shape[0] > 1:
            return loss(params, batch[:batch.shape[0] // 2])
        return loss(params, batch[:, :batch.shape[1] // 2])
    trainer.loss = half


def unchanged_state(trainer):
    step = trainer.step

    def kept(batch):
        params = trainer.params
        out = step(batch)
        trainer.params = params
        return out
    trainer.step = kept


FAULTS = {"alter_token": alter_token, "half_batch": half_batch,
          "unchanged_state": unchanged_state}


def apply(name, obj):
    FAULTS[name](obj)
