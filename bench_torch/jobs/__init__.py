"""The kinds of job a traffic mix can name in its ``call`` key, one module
each: ``spp(mix)``, the samples a job adds to each pixel, and
``call(cell, state, seed)``, the job's one render call."""
