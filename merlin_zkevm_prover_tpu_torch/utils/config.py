"""Config: JSON -> typed config object.

Full field surface of reference src/config/config.cpp (141 Parse* calls:
every json key and its environment-variable override is recognized by the
same name).  Divergences from the reference, by design:

  * runFile* modes are PATH strings here (empty = off); the reference
    models them as booleans paired with inputFile/inputFile2.  load()
    normalizes a boolean-true json value to the inputFile path.
  * artifact-path defaults (zkevmStarkInfo, recursive*, c12a*) default to
    empty instead of configPath-relative .bin/.json files — the native
    pipeline compiles its circuits from the PIL instead of loading
    pil-stark build artifacts.
  * extra knobs with no reference analog: pilFile, proverNBits, proverBlowupBits,
    proverNQueries, dbCacheSize.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict

_ENV_BY_FIELD = {
    'runExecutorServer': 'RUN_EXECUTOR_SERVER',
    'runExecutorClient': 'RUN_EXECUTOR_CLIENT',
    'runExecutorClientMultithread': 'RUN_EXECUTOR_CLIENT_MULTITHREAD',
    'runHashDBServer': 'RUN_HASHDB_SERVER',
    'runHashDBTest': 'RUN_HASHDB_TEST',
    'runAggregatorServer': 'RUN_AGGREGATOR_SERVER',
    'runAggregatorClient': 'RUN_AGGREGATOR_CLIENT',
    'runAggregatorClientMock': 'RUN_AGGREGATOR_CLIENT_MOCK',
    'runFileGenBatchProof': 'RUN_FILE_GEN_BATCH_PROOF',
    'runFileGenAggregatedProof': 'RUN_FILE_GEN_AGGREGATED_PROOF',
    'runFileGenFinalProof': 'RUN_FILE_GEN_FINAL_PROOF',
    'runFileProcessBatch': 'RUN_FILE_PROCESS_BATCH',
    'runFileProcessBatchMultithread': 'RUN_FILE_PROCESS_BATCH_MULTITHREAD',
    'runFileExecute': 'RUN_FILE_EXECUTE',
    'runKeccakScriptGenerator': 'RUN_KECCAK_SCRIPT_GENERATOR',
    'runKeccakTest': 'RUN_KECCAK_TEST',
    'runStorageSMTest': 'RUN_STORAGE_SM_TEST',
    'runBinarySMTest': 'RUN_BINARY_SM_TEST',
    'runMemAlignSMTest': 'RUN_MEM_ALIGN_SM_TEST',
    'runSHA256Test': 'RUN_SHA256_TEST',
    'runBlakeTest': 'RUN_BLAKE_TEST',
    'runECRecoverTest': 'RUN_ECRECOVER_TEST',
    'runDatabaseCacheTest': 'RUN_DATABASE_CACHE_TEST',
    'runDatabaseAssociativeCacheTest': 'RUN_DATABASE_ASSOCIATIVE_CACHE_TEST',
    'runCheckTreeTest': 'RUN_CHECK_TREE_TEST',
    'checkTreeRoot': 'CHECK_TREE_ROOT',
    'runDatabasePerformanceTest': 'RUN_DATABASE_PERFORMANCE_TEST',
    'runUnitTest': 'RUN_UNIT_TEST',
    'useMainExecGenerated': 'USE_MAIN_EXEC_GENERATED',
    'useMainExecC': 'USE_MAIN_EXEC_C',
    'executeInParallel': 'EXECUTE_IN_PARALLEL',
    'saveDbReadsToFile': 'SAVE_DB_READS_TO_FILE',
    'saveRequestToFile': 'SAVE_REQUESTS_TO_FILE',
    'saveDbReadsToFileOnChange': 'SAVE_DB_READS_TO_FILE_ON_CHANGE',
    'saveInputToFile': 'SAVE_INPUT_TO_FILE',
    'saveResponseToFile': 'SAVE_RESPONSE_TO_FILE',
    'saveOutputToFile': 'SAVE_OUTPUT_TO_FILE',
    'saveProofToFile': 'SAVE_PROOF_TO_FILE',
    'saveFilesInSubfolders': 'SAVE_FILES_IN_SUBFOLDERS',
    'loadDBToMemCache': 'LOAD_DB_TO_MEM_CACHE',
    'loadDBToMemCacheInParallel': 'LOAD_DB_TO_MEM_CACHE_IN_PARALLEL',
    'loadDBToMemTimeout': 'LOAD_DB_TO_MEM_TIMEOUT',
    'executorServerPort': 'EXECUTOR_SERVER_PORT',
    'executorClientPort': 'EXECUTOR_CLIENT_PORT',
    'executorClientHost': 'EXECUTOR_CLIENT_HOST',
    'executorClientLoops': 'EXECUTOR_CLIENT_LOOPS',
    'executorClientCheckNewStateRoot': 'EXECUTOR_CLIENT_CHECK_NEW_STATE_ROOT',
    'hashDBServerPort': 'HASHDB_SERVER_PORT',
    'hashDBURL': 'HASHDB_URL',
    'hashDB64': 'HASHDB64',
    'dbCacheSynchURL': 'DB_CACHE_SYNCH_URL',
    'aggregatorServerPort': 'AGGREGATOR_SERVER_PORT',
    'aggregatorClientPort': 'AGGREGATOR_CLIENT_PORT',
    'aggregatorClientHost': 'AGGREGATOR_CLIENT_HOST',
    'aggregatorClientMockTimeout': 'AGGREGATOR_CLIENT_MOCK_TIMEOUT',
    'aggregatorClientWatchdogTimeout': 'AGGREGATOR_CLIENT_WATCHDOG_TIMEOUT',
    'aggregatorClientMaxStreams': 'AGGREGATOR_CLIENT_MAX_STREAMS',
    'dbMTCacheSize': 'DB_MT_CACHE_SIZE',
    'useAssociativeCache': 'USE_ASSOCIATIVE_CACHE',
    'log2DbMTAssociativeCacheSize': 'LOG2_DB_MT_ASSOCIATIVE_CACHE_SIZE',
    'log2DbMTAssociativeCacheIndexesSize': 'LOG2_DB_MT_ASSOCIATIVE_CACHE_INDEXES_SIZE',
    'dbProgramCacheSize': 'DB_PROGRAM_CACHE_SIZE',
    'executorROMLineTraces': 'EXECUTOR_ROM_LINE_TRACES',
    'executorTimeStatistics': 'EXECUTOR_TIME_STATISTICS',
    'opcodeTracer': 'OPCODE_TRACER',
    'logRemoteDbReads': 'LOG_REMOTE_DB_READS',
    'logExecutorServerInput': 'LOG_EXECUTOR_SERVER_INPUT',
    'logExecutorServerInputJson': 'LOG_EXECUTOR_SERVER_INPUT_JSON',
    'logExecutorServerInputGasThreshold': 'LOG_EXECUTOR_SERVER_INPUT_GAS_THRESHOLD',
    'logExecutorServerResponses': 'LOG_EXECUTOR_SERVER_RESPONSES',
    'logExecutorServerTxs': 'LOG_EXECUTOR_SERVER_TXS',
    'dontLoadRomOffsets': 'DONT_LOAD_ROM_OFFSETS',
    'inputFile': 'INPUT_FILE',
    'inputFile2': 'INPUT_FILE_2',
    'outputPath': 'OUTPUT_PATH',
    'configPath': 'CONFIG_PATH',
    'rom': 'ROM',
    'keccakScriptFile': 'KECCAK_SCRIPT_FILE',
    'storageRomFile': 'STORAGE_ROM_FILE',
    'zkevmConstPols': 'ZKEVM_CONST_POLS',
    'zkevmConstantsTree': 'ZKEVM_CONSTANTS_TREE',
    'zkevmStarkInfo': 'ZKEVM_STARK_INFO',
    'zkevmVerifier': 'ZKEVM_VERIFIER',
    'c12aConstPols': 'C12A_CONST_POLS',
    'c12aConstantsTree': 'C12A_CONSTANTS_TREE',
    'c12aExec': 'C12A_EXEC',
    'c12aStarkInfo': 'C12A_STARK_INFO',
    'recursive1ConstPols': 'RECURSIVE1_CONST_POLS',
    'recursive1ConstantsTree': 'RECURSIVE1_CONSTANTS_TREE',
    'recursive1Exec': 'RECURSIVE1_EXEC',
    'recursive1StarkInfo': 'RECURSIVE1_STARK_INFO',
    'recursive1Verifier': 'RECURSIVE1_VERIFIER',
    'recursive2ConstPols': 'RECURSIVE2_CONST_POLS',
    'recursive2ConstantsTree': 'RECURSIVE2_CONSTANTS_TREE',
    'recursive2Exec': 'RECURSIVE2_EXEC',
    'recursive2StarkInfo': 'RECURSIVE2_STARK_INFO',
    'recursive2Verifier': 'RECURSIVE2_VERIFIER',
    'recursive2Verkey': 'RECURSIVE2_VERKEY',
    'recursivefConstPols': 'RECURSIVEF_CONST_POLS',
    'recursivefConstantsTree': 'RECURSIVEF_CONSTANTS_TREE',
    'recursivefExec': 'RECURSIVEF_EXEC',
    'recursivefStarkInfo': 'RECURSIVEF_STARK_INFO',
    'recursivefVerifier': 'RECURSIVEF_VERIFIER',
    'finalVerifier': 'FINAL_VERIFIER',
    'finalVerkey': 'FINAL_VERKEY',
    'finalStarkZkey': 'FINAL_STARK_ZKEY',
    'zkevmCmPols': 'ZKEVM_CM_POLS',
    'zkevmCmPolsAfterExecutor': 'ZKEVM_CM_POLS_AFTER_EXECUTOR',
    'c12aCmPols': 'C12A_CM_POLS',
    'recursive1CmPols': 'RECURSIVE1_CM_POLS',
    'mapConstPolsFile': 'MAP_CONST_POLS_FILE',
    'mapConstantsTreeFile': 'MAP_CONSTANTS_TREE_FILE',
    'proofFile': 'PROOF_FILE',
    'publicsOutput': 'PUBLICS_OUTPUT',
    'keccakPolsFile': 'KECCAK_POLS_FILE',
    'keccakConnectionsFile': 'KECCAK_CONNECTIONS_FILE',
    'databaseURL': 'DATABASE_URL',
    'dbNodesTableName': 'DB_NODES_TABLE_NAME',
    'dbProgramTableName': 'DB_PROGRAM_TABLE_NAME',
    'dbMultiWrite': 'DB_MULTIWRITE',
    'dbMultiWriteSingleQuerySize': 'DB_MULTIWRITE_SINGLE_QUERY_SIZE',
    'dbConnectionsPool': 'DB_CONNECTIONS_POOL',
    'dbNumberOfPoolConnections': 'DB_NUMBER_OF_POOL_CONNECTIONS',
    'dbMetrics': 'DB_METRICS',
    'dbClearCache': 'DB_CLEAR_CACHE',
    'dbGetTree': 'DB_GET_TREE',
    'dbReadOnly': 'DB_READ_ONLY',
    'dbReadRetryCounter': 'DB_READ_RETRY_COUNTER',
    'dbReadRetryDelay': 'DB_READ_RETRY_DELAY',
    'stateManager': 'STATE_MANAGER',
    'stateManagerPurge': 'STATE_MANAGER_PURGE',
    'stateManagerPurgeTxs': 'STATE_MANAGER_PURGE_TXS',
    'cleanerPollingPeriod': 'CLEANER_POLLING_PERIOD',
    'requestsPersistence': 'REQUESTS_PERSISTENCE',
    'maxExecutorThreads': 'MAX_EXECUTOR_THREADS',
    'maxProverThreads': 'MAX_PROVER_THREADS',
    'maxHashDBThreads': 'MAX_HASHDB_THREADS',
    'proverName': 'PROVER_NAME',
    'fullTracerTraceReserveSize': 'FULL_TRACER_TRACE_RESERVE_SIZE',
    'ECRecoverPrecalc': 'ECRECOVER_PRECALC',
    'ECRecoverPrecalcNThreads': 'ECRECOVER_PRECALC_N_THREADS',
}


@dataclass
class Config:
    runExecutorServer: bool = False
    runExecutorClient: bool = False
    runExecutorClientMultithread: bool = False
    runHashDBServer: bool = False
    runHashDBTest: bool = False
    runAggregatorServer: bool = False
    runAggregatorClient: bool = False
    runAggregatorClientMock: bool = False
    runFileGenBatchProof: str = ''
    runFileGenAggregatedProof: str = ''
    runFileGenFinalProof: str = ''
    runFileProcessBatch: str = ''
    runFileProcessBatchMultithread: str = ''
    runFileExecute: str = ''
    runKeccakScriptGenerator: bool = False
    runKeccakTest: bool = False
    runStorageSMTest: bool = False
    runBinarySMTest: bool = False
    runMemAlignSMTest: bool = False
    runSHA256Test: bool = False
    runBlakeTest: bool = False
    runECRecoverTest: bool = False
    runDatabaseCacheTest: bool = False
    runDatabaseAssociativeCacheTest: bool = False
    runCheckTreeTest: bool = False
    checkTreeRoot: str = 'auto'
    runDatabasePerformanceTest: bool = False
    runUnitTest: bool = False
    useMainExecGenerated: bool = True
    useMainExecC: bool = False
    executeInParallel: bool = True
    saveDbReadsToFile: bool = False
    saveRequestToFile: bool = False
    saveDbReadsToFileOnChange: bool = False
    saveInputToFile: bool = False
    saveResponseToFile: bool = False
    saveOutputToFile: bool = False
    saveProofToFile: bool = False
    saveFilesInSubfolders: bool = False
    loadDBToMemCache: bool = False
    loadDBToMemCacheInParallel: bool = False
    loadDBToMemTimeout: int = 30 * 1000 * 1000
    executorServerPort: int = 50071
    executorClientPort: int = 50071
    executorClientHost: str = '127.0.0.1'
    executorClientLoops: int = 1
    executorClientCheckNewStateRoot: bool = False
    hashDBServerPort: int = 50061
    hashDBURL: str = 'local'
    hashDB64: bool = False
    dbCacheSynchURL: str = ''
    aggregatorServerPort: int = 50081
    aggregatorClientPort: int = 50081
    aggregatorClientHost: str = '127.0.0.1'
    aggregatorClientMockTimeout: int = 60  *  1000  *  1000
    aggregatorClientWatchdogTimeout: int = 60 * 60
    aggregatorClientMaxStreams: int = 0
    dbMTCacheSize: int = 8 * 1024
    useAssociativeCache: bool = False
    log2DbMTAssociativeCacheSize: int = 24
    log2DbMTAssociativeCacheIndexesSize: int = 28
    dbProgramCacheSize: int = 1 * 1024
    executorROMLineTraces: bool = False
    executorTimeStatistics: bool = False
    opcodeTracer: bool = False
    logRemoteDbReads: bool = False
    logExecutorServerInput: bool = False
    logExecutorServerInputJson: bool = False
    logExecutorServerInputGasThreshold: int = 0
    logExecutorServerResponses: bool = False
    logExecutorServerTxs: bool = True
    dontLoadRomOffsets: bool = False
    inputFile: str = ''
    inputFile2: str = ''
    outputPath: str = 'output'
    configPath: str = 'config'
    rom: str = ''  # ref default: configPath + 'src/main_sm/'
    keccakScriptFile: str = ''  # ref default: configPath + '/scripts/keccak_script.json'
    storageRomFile: str = ''  # ref default: configPath + '/scripts/storage_sm_rom.json'
    zkevmConstPols: str = ''  # ref default: configPath + '/zkevm/zkevm.const'
    zkevmConstantsTree: str = ''  # ref default: configPath + '/zkevm/zkevm.consttree'
    zkevmStarkInfo: str = ''  # ref default: configPath + '/zkevm/zkevm.starkinfo.json'
    zkevmVerifier: str = ''  # ref default: configPath + '/zkevm/zkevm.verifier.dat'
    c12aConstPols: str = ''  # ref default: configPath + '/c12a/c12a.const'
    c12aConstantsTree: str = ''  # ref default: configPath + '/c12a/c12a.consttree'
    c12aExec: str = ''  # ref default: configPath + '/c12a/c12a.exec'
    c12aStarkInfo: str = ''  # ref default: configPath + '/c12a/c12a.starkinfo.json'
    recursive1ConstPols: str = ''  # ref default: configPath + '/recursive1/recursive1.const'
    recursive1ConstantsTree: str = ''  # ref default: configPath + '/recursive1/recursive1.consttree'
    recursive1Exec: str = ''  # ref default: configPath + '/recursive1/recursive1.exec'
    recursive1StarkInfo: str = ''  # ref default: configPath + '/recursive1/recursive1.starkinfo.json'
    recursive1Verifier: str = ''  # ref default: configPath + '/recursive1/recursive1.verifier.dat'
    recursive2ConstPols: str = ''  # ref default: configPath + '/recursive2/recursive2.const'
    recursive2ConstantsTree: str = ''  # ref default: configPath + '/recursive2/recursive2.consttree'
    recursive2Exec: str = ''  # ref default: configPath + '/recursive2/recursive2.exec'
    recursive2StarkInfo: str = ''  # ref default: configPath + '/recursive2/recursive2.starkinfo.json'
    recursive2Verifier: str = ''  # ref default: configPath + '/recursive2/recursive2.verifier.dat'
    recursive2Verkey: str = ''  # ref default: configPath + '/recursive2/recursive2.verkey.json'
    recursivefConstPols: str = ''  # ref default: configPath + '/recursivef/recursivef.const'
    recursivefConstantsTree: str = ''  # ref default: configPath + '/recursivef/recursivef.consttree'
    recursivefExec: str = ''  # ref default: configPath + '/recursivef/recursivef.exec'
    recursivefStarkInfo: str = ''  # ref default: configPath + '/recursivef/recursivef.starkinfo.json'
    recursivefVerifier: str = ''  # ref default: configPath + '/recursivef/recursivef.verifier.dat'
    finalVerifier: str = ''  # ref default: configPath + '/final/final.verifier.dat'
    finalVerkey: str = ''  # ref default: configPath + '/final/final.fflonk.verkey.json'
    finalStarkZkey: str = ''  # ref default: configPath + '/final/final.fflonk.zkey'
    zkevmCmPols: str = ''
    zkevmCmPolsAfterExecutor: str = ''
    c12aCmPols: str = ''
    recursive1CmPols: str = ''
    mapConstPolsFile: bool = False
    mapConstantsTreeFile: bool = False
    proofFile: str = 'proof.json'
    publicsOutput: str = 'public.json'
    keccakPolsFile: str = 'keccak_pols.json'
    keccakConnectionsFile: str = 'keccak_connections.json'
    databaseURL: str = ':memory:'
    dbNodesTableName: str = 'state.nodes'
    dbProgramTableName: str = 'state.program'
    dbMultiWrite: bool = True
    dbMultiWriteSingleQuerySize: int = 20 * 1024 * 1024
    dbConnectionsPool: bool = True
    dbNumberOfPoolConnections: int = 30
    dbMetrics: bool = True
    dbClearCache: bool = False
    dbGetTree: bool = True
    dbReadOnly: bool = False
    dbReadRetryCounter: int = 10
    dbReadRetryDelay: int = 100
    stateManager: bool = True
    stateManagerPurge: bool = True
    stateManagerPurgeTxs: bool = True
    cleanerPollingPeriod: int = 600
    requestsPersistence: int = 3600
    maxExecutorThreads: int = 6
    maxProverThreads: int = 8
    maxHashDBThreads: int = 8
    proverName: str = 'tpu-prover'
    fullTracerTraceReserveSize: int = 256 * 1024
    ECRecoverPrecalc: bool = False
    ECRecoverPrecalcNThreads: int = 16

    # --- extensions with no reference analog ---
    pilFile: str = ""   # compiled PIL (main.pil.json); enables the real zkEVM circuit
    romFile: str = ""   # alias of `rom` (the reference json key)
    zkeyFile: str = ""
    dbCacheSize: int = 1 << 20
    proverNBits: int = 10
    proverBlowupBits: int = 2
    proverNQueries: int = 16

    extra: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def load(source) -> "Config":
        if isinstance(source, str):
            with open(source) as f:
                data = json.load(f)
        else:
            data = dict(source)
        cfg = Config()
        known = {f.name: f.type for f in dataclasses.fields(Config)}
        for k, v in data.items():
            if k == "rom":
                cfg.romFile = v  # keep the alias in sync
            if k in known and k != "extra":
                if k.startswith("runFile") and isinstance(v, bool):
                    # reference models runFile* as bool + inputFile path
                    v = (data.get("inputFile", cfg.inputFile) or "") if v \
                        else ""
                setattr(cfg, k, v)
            else:
                cfg.extra[k] = v
        # environment overrides (reference ParseEnvironment*)
        for name, env in _ENV_BY_FIELD.items():
            raw = os.environ.get(env)
            if raw is None:
                continue
            cur = getattr(cfg, name)
            if isinstance(cur, bool):
                setattr(cfg, name, raw.lower() == "true")
            elif isinstance(cur, int):
                try:
                    setattr(cfg, name, int(raw))
                except ValueError:
                    pass
            else:
                setattr(cfg, name, raw)
        return cfg

    def print(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def generate_proof(self) -> bool:
        return bool(
            self.runAggregatorClient or self.runFileGenBatchProof
            or self.runFileGenAggregatedProof or self.runFileGenFinalProof
        )
